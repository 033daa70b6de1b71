"""Constrained MDP: continuous-action Cartpole with safety costs (paper
Section 4; port of ``repro.tasks.cmdp``).

Gaussian-policy MLP + value baseline; each client j has its own safety
budget d_j in [25, 35]:

    f_j(w) = -E[sum_t r_t]          g_j(w) = E[sum_t c_t] - d_j

Cost: 1 per step when the cart is inside a prohibited zone or |theta| > 6
deg.  ``loss_pair`` uses the value/gradient splice ``(true_value).detach()
+ (surrogate - surrogate.detach())``, so the switching rule sees the exact
constraint values while the gradients are REINFORCE.

Every random law is a draw and a deterministic core: :func:`rollout_draws`
draws an episode batch's start states and action noise from a CPU
``torch.Generator``; :func:`rollout` runs the episodes from them.  A batch
of the engine is a :class:`CMDPBatch` of such draws and the budget, and a
fleet's shard rows are draws too (:func:`make_fleet`), so provisioning is
an index gather with no generator per round and client.

The rollout is a Python loop over ``[E, ...]`` tensors under
``torch.no_grad()``: the actions are sampled and detached, so no gradient
flows through the dynamics; the gradient comes from one batched
``policy_dist`` / ``value`` pass over the visited states afterwards.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

# -- dynamics constants (OpenAI gym cartpole, continuous force) -------------
GRAVITY, M_CART, M_POLE = 9.8, 1.0, 0.1
LENGTH, FORCE_MAG, TAU = 0.5, 10.0, 0.02
M_TOTAL = M_CART + M_POLE
PM_L = M_POLE * LENGTH
THETA_FAIL = 12 * 3.14159 / 180
THETA_COST = 6 * 3.14159 / 180
X_FAIL = 2.4
ZONES = torch.tensor([[-2.4, -2.2], [-1.3, -1.1], [-0.1, 0.1],
                      [1.1, 1.3], [2.2, 2.4]], dtype=torch.float32)

# the thresholds as float32 values: the reference compares float32 states
# with weakly typed Python scalars, i.e. with the scalars rounded to float32
_THETA_FAIL32 = float(np.float32(THETA_FAIL))
_THETA_COST32 = float(np.float32(THETA_COST))
_X_FAIL32 = float(np.float32(X_FAIL))


def env_step(state: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
    """One Euler step of ``[..., 4]`` states (x, x', theta, theta') under
    ``[...]`` forces."""
    x, xd, th, thd = state.unbind(-1)
    cos, sin = torch.cos(th), torch.sin(th)
    temp = (force + PM_L * thd ** 2 * sin) / M_TOTAL
    th_acc = (GRAVITY * sin - cos * temp) / \
        (LENGTH * (4.0 / 3.0 - M_POLE * cos ** 2 / M_TOTAL))
    x_acc = temp - PM_L * th_acc * cos / M_TOTAL
    x = x + TAU * xd
    xd = xd + TAU * x_acc
    th = th + TAU * thd
    thd = thd + TAU * th_acc
    return torch.stack([x, xd, th, thd], dim=-1)


def step_cost(state: torch.Tensor) -> torch.Tensor:
    """1.0 where a ``[..., 4]`` state is in a prohibited zone or tilted past
    6 degrees, else 0.0."""
    x, th = state[..., 0], state[..., 2]
    zones = ZONES.to(state.device)
    in_zone = ((x[..., None] >= zones[:, 0])
               & (x[..., None] <= zones[:, 1])).any(-1)
    return (in_zone | (th.abs() > _THETA_COST32)).to(torch.float32)


def terminated(state: torch.Tensor) -> torch.Tensor:
    x, th = state[..., 0], state[..., 2]
    return (x.abs() > _X_FAIL32) | (th.abs() > _THETA_FAIL32)


# -- Gaussian policy + value MLPs --------------------------------------------

def init_params(gen: torch.Generator, hidden: int = 64, device="cuda"):
    """Policy and value MLPs (4 -> hidden -> hidden -> 1), weights normal /
    sqrt(fan-in) from the CPU generator ``gen``, zero biases and log-std, on
    ``device`` (``cuda`` unless asked for the CPU)."""
    dev = resolve_device(device)

    def lin(i, o):
        return {"w": (torch.randn((i, o), generator=gen) / np.sqrt(i)
                      ).to(dev),
                "b": torch.zeros(o, device=dev)}
    pi = {"l1": lin(4, hidden), "l2": lin(hidden, hidden),
          "mu": lin(hidden, 1)}
    pi["log_std"] = torch.zeros((), device=dev)
    v = {"l1": lin(4, hidden), "l2": lin(hidden, hidden),
         "out": lin(hidden, 1)}
    return {"pi": pi, "v": v}


def _mlp2(p, x, out_key):
    h = torch.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
    h = torch.tanh(h @ p["l2"]["w"] + p["l2"]["b"])
    return h @ p[out_key]["w"] + p[out_key]["b"]


def policy_dist(params, obs):
    mu = _mlp2(params["pi"], obs, "mu")[..., 0]
    return mu, torch.exp(params["pi"]["log_std"])


def value(params, obs):
    return _mlp2(params["v"], obs, "out")[..., 0]


def log_prob(mu, std, a):
    return -0.5 * ((a - mu) / std) ** 2 - torch.log(std) - 0.919


class Trajectory(NamedTuple):
    obs: torch.Tensor        # [E, T, 4]
    actions: torch.Tensor    # [E, T]
    rewards: torch.Tensor    # [E, T]
    costs: torch.Tensor      # [E, T]
    alive: torch.Tensor      # [E, T]


class CMDPBatch(NamedTuple):
    """One client's rollout draws and safety budget (stacked: a leading
    ``[n_clients]`` axis, or ``[n_clients, pool]`` in a fleet's shards)."""
    s0: torch.Tensor         # [E, 4] start states
    noise: torch.Tensor      # [T, E] standard normal action noise
    budget: torch.Tensor     # [] safety budget d_j


def rollout_draws(gen: torch.Generator, n_episodes: int, horizon: int = 200):
    """``(s0 [E, 4] uniform in [-0.05, 0.05), noise [T, E] standard
    normal)`` from the CPU generator ``gen``."""
    s0 = torch.rand((n_episodes, 4), generator=gen) * 0.1 - 0.05
    noise = torch.randn((horizon, n_episodes), generator=gen)
    return s0, noise


def rollout(params, s0: torch.Tensor, noise: torch.Tensor) -> Trajectory:
    """On-policy episodes from start states ``s0 [E, 4]`` with action noise
    ``noise [T, E]`` (actions ``mu + std * noise``, detached)."""
    s = s0
    alive = torch.ones(s.shape[0], device=s.device)
    obs, acts, rews, costs, alives = [], [], [], [], []
    with torch.no_grad():
        for eps in noise:
            mu, std = policy_dist(params, s)
            a = mu + std * eps
            s_new = env_step(s, FORCE_MAG * torch.tanh(a))
            obs.append(s)
            acts.append(a)
            rews.append(alive)
            costs.append(step_cost(s) * alive)
            alives.append(alive)
            alive = alive * (1.0 - terminated(s_new).to(torch.float32))
            s = s_new
    return Trajectory(torch.stack(obs, 1), torch.stack(acts, 1),
                      torch.stack(rews, 1), torch.stack(costs, 1),
                      torch.stack(alives, 1))


def returns_to_go(x: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """``out[:, t] = x[:, t] + gamma * out[:, t + 1]`` over ``[E, T]``, summed
    back to front in float32, the reference's order (its compiled scan
    fuses the multiply-add, so for gamma != 1 the two agree to rounding)."""
    carry = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    for t in range(x.shape[1] - 1, -1, -1):
        carry = x[:, t] + gamma * carry
        out[:, t] = carry
    return out


def _counts_to_go(x: torch.Tensor) -> torch.Tensor:
    """``returns_to_go(x, 1.0)`` of 0/1 rewards or costs: every partial sum
    is an integer below 2^24, so the reversed running sum is exact in any
    order (one pass instead of T)."""
    return torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])


def make_loss_pair(n_episodes: int = 5, horizon: int = 200,
                   gamma: float = 1.0, vf_coef: float = 0.25):
    """``loss_pair(params, batch: CMDPBatch) -> (f, g)`` for FedSGM; the
    batch's draws hold ``n_episodes`` episodes of ``horizon`` steps."""
    to_go = _counts_to_go if gamma == 1.0 else \
        (lambda x: returns_to_go(x, gamma))

    def loss_pair(params, batch: CMDPBatch):
        s0, noise, budget = batch
        if s0.shape[0] != n_episodes or noise.shape[0] != horizon:
            raise ValueError(
                f"draws of {s0.shape[0]} episodes x {noise.shape[0]} steps; "
                f"loss_pair expects {n_episodes} x {horizon}")
        traj = rollout(params, s0, noise)
        mu, std = policy_dist(params, traj.obs)
        logp = log_prob(mu, std, traj.actions) * traj.alive

        r_ret = to_go(traj.rewards)
        c_ret = to_go(traj.costs)
        v = value(params, traj.obs)
        adv_r = (r_ret - v).detach()
        adv_c = c_ret - c_ret.mean()

        ep_reward = traj.rewards.sum(-1).mean()
        ep_cost = traj.costs.sum(-1).mean()

        sur_f = -(logp * adv_r).sum(-1).mean() \
            + vf_coef * ((v - r_ret) ** 2 * traj.alive).mean()
        sur_g = (logp * adv_c).sum(-1).mean()

        # value/gradient splice: exact values, REINFORCE gradients
        f = (-ep_reward).detach() + sur_f - sur_f.detach()
        g = (ep_cost - budget).detach() + sur_g - sur_g.detach()
        return f, g

    return loss_pair


def client_budgets(n_clients: int, lo: float = 25.0, hi: float = 35.0
                   ) -> torch.Tensor:
    return torch.linspace(lo, hi, n_clients)


def fleet_draws(gen: torch.Generator, n_clients: int, pool: int,
                n_episodes: int = 5, horizon: int = 200):
    """Every shard row's rollout draws, client by client and row by row
    from the CPU generator ``gen``: ``(s0 [n, pool, E, 4], noise [n, pool,
    T, E])``."""
    rows = [rollout_draws(gen, n_episodes, horizon)
            for _ in range(n_clients * pool)]
    s0 = torch.stack([r[0] for r in rows])
    noise = torch.stack([r[1] for r in rows])
    return (s0.reshape((n_clients, pool) + s0.shape[1:]),
            noise.reshape((n_clients, pool) + noise.shape[1:]))


def fleet_from_draws(s0: torch.Tensor, noise: torch.Tensor,
                     lo: float = 25.0, hi: float = 35.0, device=None):
    """The CMDP fleet over given shard draws (``[n, pool, ...]``): each row
    pairs its draws with the client's budget d_j."""
    from repro_torch.fleet import provision
    n, pool = s0.shape[:2]
    budgets = client_budgets(n, lo, hi)[:, None].expand(n, pool)
    return provision.from_stacked(CMDPBatch(
        s0.to(device), noise.to(device), budgets.contiguous().to(device)))


def make_fleet(gen: torch.Generator, cfg, pool: int = 64, lo: float = 25.0,
               hi: float = 35.0, n_episodes: int = 5, horizon: int = 200,
               device="cuda"):
    """Client population for the CMDP task (``repro_torch.fleet``): each
    client's shard is a pool of rollout draws paired with its safety budget
    d_j, drawn from the CPU generator ``gen`` and put on ``device`` once, so
    provisioning (``fleet.batch_size=1, redraw=True``) hands every round a
    fresh on-policy draw per client by an index gather.  Use with
    :func:`fleet_loss_pair`."""
    s0, noise = fleet_draws(gen, cfg.n_clients, pool, n_episodes, horizon)
    return fleet_from_draws(s0, noise, lo, hi, resolve_device(device))


def fleet_loss_pair(n_episodes: int = 5, horizon: int = 200, **kw):
    """loss_pair over fleet-provisioned batches: rows of (draws, budget);
    the first drawn row drives this round's rollout."""
    base = make_loss_pair(n_episodes, horizon, **kw)

    def loss_pair(params, batch: CMDPBatch):
        return base(params, CMDPBatch(*(leaf[0] for leaf in batch)))

    return loss_pair


def eval_policy(params, gen: torch.Generator, n_episodes: int = 10,
                horizon: int = 200) -> dict:
    """Mean episodic reward and cost of ``n_episodes`` fresh episodes drawn
    from the CPU generator ``gen``."""
    s0, noise = rollout_draws(gen, n_episodes, horizon)
    dev = params["pi"]["log_std"].device
    traj = rollout(params, s0.to(dev), noise.to(dev))
    return {"reward": float(traj.rewards.sum(-1).mean()),
            "cost": float(traj.costs.sum(-1).mean())}

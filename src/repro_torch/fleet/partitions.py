"""Non-IID client partitioners (port of ``repro.fleet.partitions``).

A partitioner maps a dataset of n samples onto n_clients padded shards of
sample *indices* -- a :class:`ClientPartition` of ``idx`` (``[J, cap]``
int64) plus a per-client ``count`` (``[J]`` int64, valid rows per shard).

Registered partitioners:

* ``iid``        -- equal-size uniform split,
* ``dirichlet``  -- label skew: per-class client proportions ~ Dir(alpha),
  realized as an exact partition through largest-remainder quotas per
  class; ``balance=True`` re-slices the client-grouped assignment into
  equal-size shards,
* ``zipf``       -- quantity skew: shard sizes follow a Zipf law (client 0
  largest), ragged counts under the padded cap,
* ``shift``      -- IID split plus a per-client Gaussian drift added to the
  feature leaves at build time.

Every random law is split in two: a draw from a ``torch.Generator`` (the
permutation, the Dirichlet proportions, the drift normals) and a
deterministic core that takes the draws as tensors (``*_core``), so the
same draws give the reference's ``idx`` and ``count`` bit for bit.  The
partitions are small (n samples of one dataset) and are computed on the
CPU, once, when a fleet is built.

Ragged shards pad ``idx`` with the shard's own first row, so a padded row
always gathers the owning client's data; provisioning only draws rows
below ``count``.  Counts clip to the cap: rows past it are dropped, as in
the reference (``pack_shards``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

_PARTITIONERS: dict = {}


def register_partitioner(cls):
    """Class decorator: register a Partitioner under its ``name``."""
    _PARTITIONERS[cls.name] = cls
    return cls


def get_partitioner(name: str) -> "Partitioner":
    try:
        cls = _PARTITIONERS[name]
    except KeyError:
        raise ValueError(f"unknown partitioner {name!r}; "
                         f"registered: {sorted(_PARTITIONERS)}") from None
    return cls()


def partitioner_names() -> tuple:
    return tuple(sorted(_PARTITIONERS))


class ClientPartition(NamedTuple):
    idx: torch.Tensor       # [n_clients, cap] int64 sample indices (padded)
    count: torch.Tensor     # [n_clients] int64 valid rows per shard


# ---------------------------------------------------------------------------
# Deterministic cores
# ---------------------------------------------------------------------------

def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of a short CPU vector, added left to right (the order
    the reference's CPU reduction takes for up to 32 entries)."""
    return torch.from_numpy(np.cumsum(x.numpy(), dtype=np.float32)[-1:]
                            ).reshape(())


def _cumsum16(a: np.ndarray) -> np.ndarray:
    if a.shape[0] <= 16:
        return np.cumsum(a, dtype=np.float32)
    nb = -(-a.shape[0] // 16)
    rows = np.zeros(nb * 16, np.float32)
    rows[:a.shape[0]] = a
    inner = np.cumsum(rows.reshape(nb, 16), axis=1, dtype=np.float32)
    carry = np.zeros(nb, np.float32)
    carry[1:] = _cumsum16(inner[:, -1].copy())[:-1]
    return (inner + carry[:, None]).reshape(-1)[:a.shape[0]]


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 running sum of a CPU vector in the reference's CPU order:
    left to right within blocks of 16, each block then offset by the
    running sum (in the same order) of the blocks before it."""
    return torch.from_numpy(_cumsum16(x.numpy().astype(np.float32)))


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def largest_remainder(raw: torch.Tensor, total) -> torch.Tensor:
    """Integer quotas summing exactly to ``total`` from float32 targets
    ``raw`` (floor everything, then hand the deficit to the largest
    remainders, ties to the lower index)."""
    base = torch.floor(raw).to(torch.int64)
    rem = raw - base.to(raw.dtype)
    deficit = int(total) - int(base.sum())
    order = _stable_argsort(-rem)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0])
    return base + (rank < deficit).to(torch.int64)


def _group_by_client(client_of: torch.Tensor) -> torch.Tensor:
    """Sample ids grouped by client, original order kept within a client
    (the reference's two-key lexsort is one stable sort)."""
    return _stable_argsort(client_of)


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def _pad_rows(order: torch.Tensor, offsets: torch.Tensor,
              sizes: torch.Tensor, cap: int, n: int) -> ClientPartition:
    """Shard j: ``order[offsets[j] : offsets[j] + min(sizes[j], cap)]``,
    padded to ``cap`` with its own first row."""
    k = torch.arange(cap)
    flat = torch.clamp(offsets[:, None] + k[None, :], 0, n - 1)
    idx = order[flat]
    count = torch.clamp(sizes, max=cap)
    idx = torch.where(k[None, :] < torch.clamp(count, min=1)[:, None],
                      idx, idx[:, :1])
    return ClientPartition(idx, count)


def pack_shards(client_of: torch.Tensor, n_clients: int,
                cap: int) -> ClientPartition:
    """``[n]`` client assignment -> padded per-client index shards.  Counts
    clip to ``cap``: the rows past it are dropped."""
    counts = torch.bincount(client_of, minlength=n_clients)
    return _pad_rows(_group_by_client(client_of), _offsets(counts), counts,
                     cap, client_of.shape[0])


def _ensure_nonempty(client_of: torch.Tensor, n_clients: int
                     ) -> torch.Tensor:
    """Reassign one sample from the largest shard (the first, on a tie) to
    each empty client, so every shard holds >= 1 row while the assignment
    stays an exact partition."""
    n = client_of.shape[0]
    counts = torch.bincount(client_of, minlength=n_clients)
    donor = int(torch.argmax(counts))
    empty = counts == 0
    rank = torch.cumsum(empty.to(torch.int64), 0) - empty.to(torch.int64)
    steal = min(int(empty.sum()), int(counts[donor]) - 1)
    order = _group_by_client(client_of)
    rows = order[torch.clamp(_offsets(counts)[donor] + rank, 0, n - 1)]
    take = empty & (rank < steal)
    out = client_of.clone()
    out[rows[take]] = torch.arange(n_clients)[take]
    return out


def iid_core(perm: torch.Tensor, n_clients: int) -> ClientPartition:
    """Equal-size split of a permutation of ``[0, n)`` (the remainder
    samples are dropped)."""
    per = perm.shape[0] // n_clients
    idx = perm[: per * n_clients].reshape(n_clients, per).to(torch.int64)
    return ClientPartition(idx, torch.full((n_clients,), per,
                                           dtype=torch.int64))


def dirichlet_core(props: torch.Tensor, labels: torch.Tensor,
                   n_clients: int, n_classes: int, cap: int,
                   balance: bool = False) -> ClientPartition:
    """Label-skew exact partition from per-class client proportions
    ``props`` (``[n_classes, n_clients]`` float32): largest-remainder
    quotas per class, each class's samples (in index order) dealt to the
    clients by the quotas' running sums.  Clients without any quota get
    one row from the largest shard."""
    n = labels.shape[0]
    labels = labels.to(torch.int64)
    class_counts = torch.bincount(labels, minlength=n_classes)[:n_classes]
    raw = props.to(torch.float32) * class_counts[:, None].to(torch.float32)
    quota = torch.stack([largest_remainder(raw[c], class_counts[c])
                         for c in range(n_classes)])
    qcum = torch.cumsum(quota, 1)                               # [C, J]
    order_cls = _stable_argsort(labels)                          # by class
    cls_sorted = labels[order_cls]
    pos_in_class = torch.arange(n) - _offsets(class_counts)[cls_sorted]
    client_sorted = torch.searchsorted(
        qcum[cls_sorted], pos_in_class[:, None], right=True)[:, 0]
    client_of = torch.empty(n, dtype=torch.int64)
    client_of[order_cls] = torch.clamp(client_sorted, 0, n_clients - 1)
    if balance:
        # the j-th contiguous slice of the client-grouped assignment:
        # sizes equalize, skew approximately kept, partition exact
        per = n // n_clients
        order = _group_by_client(client_of)
        return ClientPartition(
            order[: per * n_clients].reshape(n_clients, per),
            torch.full((n_clients,), per, dtype=torch.int64))
    return pack_shards(_ensure_nonempty(client_of, n_clients), n_clients, cap)


def zipf_sizes(n: int, n_clients: int, a: float) -> torch.Tensor:
    """Shard sizes ∝ (j+1)^-a summing to n, every client >= 1 row (the
    rows given to empty clients come off the largest)."""
    raw = torch.arange(1, n_clients + 1, dtype=torch.float32) ** (-float(a))
    sizes = largest_remainder(raw / sum_f32(raw) * n, n)
    short = (sizes == 0).to(torch.int64)
    sizes = sizes + short
    sizes[torch.argmax(sizes)] -= short.sum()
    return sizes


def zipf_core(perm: torch.Tensor, n_clients: int, a: float,
              cap: int) -> ClientPartition:
    """Quantity skew: client j holds the next ``sizes[j]`` entries of the
    permutation (clipped to ``cap``)."""
    n = perm.shape[0]
    sizes = zipf_sizes(n, n_clients, a)
    return _pad_rows(perm.to(torch.int64), _offsets(sizes), sizes, cap, n)


def infer_n_classes(labels: torch.Tensor, configured: int = 0) -> int:
    """The class count: the configured value, else read from the labels
    (on the host; this runs once, when a fleet is built)."""
    if configured:
        return int(configured)
    return int(labels.max()) + 1


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def permutation(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randperm(n, generator=gen)


def _log_gamma(gen: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """log of Gamma(alpha, 1) draws in float64: Marsaglia-Tsang for shape
    alpha + 1 (>= 1) and, for alpha < 1, the boost Gamma(alpha) =
    Gamma(alpha + 1) * U^(1/alpha), kept in log space so that a tiny alpha
    does not underflow.  Each pass draws one normal and one uniform for
    every entry and keeps them where the entry is still pending."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float64)
    pending = torch.ones(shape, dtype=torch.bool)
    while bool(pending.any()):
        x = torch.randn(shape, generator=gen, dtype=torch.float64)
        u = torch.rand(shape, generator=gen, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        ok &= pending
        out = torch.where(ok, math.log(d) + torch.log(
            torch.clamp(v, min=1e-300)), out)
        pending &= ~ok
    if alpha < 1.0:
        u = torch.rand(shape, generator=gen, dtype=torch.float64)
        out = out + torch.log(u) / alpha
    return out


def dirichlet(gen: torch.Generator, alpha: float, n_rows: int,
              n_cols: int) -> torch.Tensor:
    """``[n_rows, n_cols]`` float32 rows ~ Dir(alpha, ..., alpha),
    normalized in log space (a row of tiny Gammas is not 0/0)."""
    return torch.softmax(_log_gamma(gen, float(alpha), (n_rows, n_cols)),
                         dim=-1).to(torch.float32)


def shift_normals(gen: torch.Generator, shards) -> list:
    """One drift draw per leaf of ``shards`` (``[J, 1, ..., d]`` normals on
    the leaf's device for a float leaf of rank >= 3, None otherwise)."""
    out = []
    for leaf in leaves_of(shards):
        if leaf.dim() < 3 or not leaf.dtype.is_floating_point:
            out.append(None)
            continue
        shape = (leaf.shape[0],) + (1,) * (leaf.dim() - 2) + leaf.shape[-1:]
        out.append(torch.randn(shape, generator=gen,
                               dtype=leaf.dtype).to(leaf.device))
    return out


def shift_core(shards, normals, shift: float):
    """``leaf + shift * normal`` for each leaf with a drift draw."""
    leaves = [leaf if z is None else leaf + shift * z
              for leaf, z in zip(leaves_of(shards), normals)]
    return rebuild(shards, leaves)


def leaves_of(batch) -> list:
    """The tensors of a batch tuple (or of a single tensor).  A ``None``
    field (``LMBatch.media`` of a token-only batch) is no leaf, as in
    ``jax.tree_util``."""
    if isinstance(batch, tuple):
        return [x for x in batch if x is not None]
    return [batch]


def rebuild(batch, leaves):
    """``batch``'s tuple type (a NamedTuple too) over new ``leaves``, one
    for each tensor field in order; ``None`` fields stay ``None``."""
    if not isinstance(batch, tuple):
        return leaves[0]
    it = iter(leaves)
    vals = [None if x is None else next(it) for x in batch]
    return type(batch)(*vals) if hasattr(batch, "_fields") else tuple(vals)


# ---------------------------------------------------------------------------
# Registry entries
# ---------------------------------------------------------------------------

class Partitioner:
    """One client-population law: index shards + optional build transform."""

    name: str = "?"
    ragged: bool = False            # per-client counts vary

    def cap(self, n: int, n_clients: int, cfg) -> int:
        """Shard capacity (rows) for this law under ``cfg``."""
        return n // n_clients

    def partition(self, gen: torch.Generator, n: int, n_clients: int, cfg,
                  labels: Optional[torch.Tensor] = None) -> ClientPartition:
        raise NotImplementedError

    def transform(self, gen: torch.Generator, shards, cfg):
        """Optional value transform of the gathered ``[J, cap, ...]``
        shards (covariate drift); identity by default."""
        return shards

    def _require_labels(self, labels):
        if labels is None:
            raise ValueError(
                f"partitioner {self.name!r} needs labels "
                "(pass labels= to provision.build_fleet)")


@register_partitioner
class IIDPartitioner(Partitioner):
    """Uniform random permutation into n_clients equal shards."""

    name = "iid"

    def partition(self, gen, n, n_clients, cfg, labels=None):
        return iid_core(permutation(gen, n), n_clients)


@register_partitioner
class DirichletPartitioner(Partitioner):
    """Label skew: per-class client proportions ~ Dir(alpha), an exact
    partition through largest-remainder quotas."""

    name = "dirichlet"
    ragged = True               # equal-size under cfg.balance

    def cap(self, n, n_clients, cfg):
        if cfg.balance:
            return n // n_clients
        return min(n, int(math.ceil(cfg.cap_factor * n / n_clients)))

    def partition(self, gen, n, n_clients, cfg, labels=None):
        self._require_labels(labels)
        labels = labels.cpu()
        n_classes = infer_n_classes(labels, cfg.n_classes)
        props = dirichlet(gen, cfg.alpha, n_classes, n_clients)
        return dirichlet_core(props, labels, n_clients, n_classes,
                              self.cap(n, n_clients, cfg),
                              balance=cfg.balance)


@register_partitioner
class ZipfPartitioner(Partitioner):
    """Quantity skew: shard sizes ∝ (j+1)^-a (every client keeps >= 1
    row)."""

    name = "zipf"
    ragged = True

    def cap(self, n, n_clients, cfg):
        return min(n, int(math.ceil(cfg.cap_factor * n / n_clients)))

    def partition(self, gen, n, n_clients, cfg, labels=None):
        return zipf_core(permutation(gen, n), n_clients, cfg.zipf_a,
                         self.cap(n, n_clients, cfg))


@register_partitioner
class FeatureShiftPartitioner(Partitioner):
    """IID split + per-client covariate drift: every float feature leaf
    (``[J, cap, ..., d]``) gains a client-specific Gaussian offset of scale
    ``cfg.shift`` along its trailing dim; labels (rank-2 leaves) and
    integer leaves are left as they are."""

    name = "shift"

    def partition(self, gen, n, n_clients, cfg, labels=None):
        return iid_core(permutation(gen, n), n_clients)

    def transform(self, gen, shards, cfg):
        if not cfg.shift:
            return shards
        return shift_core(shards, shift_normals(gen, shards), cfg.shift)

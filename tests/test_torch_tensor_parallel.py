"""Tensor parallelism inside the dense transformer family on a rank mesh's
model axis: the plan (``sharding.partition.tensor_plan``), the column <->
tensor layout maps (``comm.flat.TensorLayout``), the layers' collectives
(``sharding.collectives``: "f", "g" and the MAX reduce), the
vocab-parallel cross-entropy, and rounds whose model ranks share each
client's forward and backward, on the CPU.

Gloo worlds of ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` data x model ranks
(``spawn``, rendezvous through a ``FileStore``, one intra-op thread a
rank; ``tests/torch_multidev_world.py``'s ``tp_world_main``) run the
reduced smollm-360m (attention whole: 1 kv head), qwen3-4b, minitron-4b
(2 kv heads: attention split at M = 2, whole at M = 4) and gemma3-4b (4
layers: one stacked period of its 2:1 pattern and one ``rest`` layer);
the test's own process runs the same with no mesh, and the reference's
no-mesh functions on the same numpy weights.

Tolerances and why:

* the layout maps, "f", "g", the MAX reduce and their gradients:
  bit-equal (they move or add values in rank order);
* the vocab-parallel CE against ``common.cross_entropy`` on the whole
  logits: rtol 1e-6 for the value and the gradient (the sum of
  exponentials adds the blocks' partial sums: another order);
* a forward's logits against one process: rtol 1e-5 / atol 1e-5
  (logits of about 1 differ by up to 2.4e-6); f and g: rtol 1e-5; the
  gradient of f: rtol 1e-5 / atol 1e-6 (a row-parallel product
  adds M partial sums of its inner dim, the logsumexp M partial sums;
  entries that cancel to near zero keep an absolute error of up to about
  2e-7, in entries of 1e-3);
  against the reference: the port's own law of
  ``test_torch_families.py``, rtol 1e-5 for the logits (atol 1e-5), f and
  g, rtol 1e-4 / atol 1e-6 for the gradient;
* rounds on an uncompressed wire against one process: every float within
  rtol 1e-5 / atol 1e-7 (the reference's own tolerance between its mesh
  and no-mesh runs, ``tests/test_scale.py``);
* rounds on the pallas top-k and quant wires: f, g_hat, sigma, f_full,
  g_full and ``delta_norm`` within rtol 1e-5, ``feasible`` and the wire
  bytes equal; all but 0.1% of w, x and the averaged-iterate sum within
  rtol 1e-4 / atol 1e-6 (the law of ``test_torch_media_rounds.py``: a
  near-tie may flip a top-k member or a quant level; measured at most
  0.008% of w); each residual row within 5% of one process's in norm (a
  flipped quant level moves its entry by a whole level, twice the bound
  of a residual entry: 8-bit quant rows measured 0.7-1.7% apart, with
  900-1,900 of 426,752 entries beyond rtol 1e-4 / atol 1e-6; top-k rows
  at most 0.3%);
* across the ranks of a world: every rank's gathered state and metrics,
  f, g and the whole leaves' gradients bit-equal;
* under the logical table that keeps the models whole: bit-equal to one
  process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multidev_world as world_mod
from repro import configs as jax_configs
from repro.comm import flat as jax_flat
from repro.models import build as jax_build
from repro.tasks import lm as jax_lm
from repro_torch import configs
from repro_torch.comm import flat
from repro_torch.configs.base import CompressorConfig, FedConfig
from repro_torch.models import build, common
from repro_torch.sharding import partition
from torch_port_util import assert_bits_equal, n

pytestmark = pytest.mark.multidev
MESHES = ((1, 2), (2, 2), (1, 4))
MESH_IDS = {shape: f"{shape[0]}x{shape[1]}" for shape in MESHES}
ARCHS = configs.all_arch_names()
LAYERS = {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``get(shape)``: each rank's results of the tensor-parallel world on
    the data x model mesh ``shape`` (spawned on first use)."""
    cache = {}

    def get(shape):
        if shape not in cache:
            folder = str(tmp_path_factory.mktemp(f"tp{MESH_IDS[shape]}"))
            cache[shape] = world_mod.spawn_tp_world(shape, folder)
        return cache[shape]
    return get


@pytest.fixture(scope="module")
def single():
    """The same in this process, with no mesh (computed on first use):
    ``get("forward", arch)`` or ``get("case", name)``."""
    cache = {}

    def get(kind, name):
        if (kind, name) not in cache:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                cache[kind, name] = world_mod.tp_forward_grad(name) \
                    if kind == "forward" else world_mod.run_tp_case(name)
            finally:
                torch.set_num_threads(threads)
        return cache[kind, name]
    return get


@pytest.fixture(scope="module")
def reference():
    """``get(arch)``: the reference's logits, f, g and the gradient of f
    (flat) on the port's weights and batch (computed on first use)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = world_mod.tp_config(arch)
            jcfg = dataclasses.replace(jax_configs.get_reduced(arch),
                                       **world_mod.TP_ARCHS[arch])
            params = jax.tree_util.tree_map(
                lambda x: jnp.asarray(n(x)), world_mod.tp_params(cfg))
            toks, mask = world_mod.tp_batch(cfg.vocab)
            fns = jax_build(jcfg)
            pair = jax_lm.make_loss_pair(fns.forward, jcfg, budget=6.0)
            batch = jax_lm.LMBatch(jnp.asarray(n(toks).astype(np.int32)),
                                   jnp.asarray(n(mask)))
            logits = fns.forward(params, jcfg, batch.tokens)
            (f, g), grad = jax.value_and_grad(lambda p: pair(p, batch),
                                              has_aux=True)(params)
            cache[arch] = {"logits": np.asarray(logits), "f": float(f),
                           "g": float(g), "grad": np.asarray(
                               jax_flat.flatten(jax_flat.spec_of(grad),
                                                grad))}
        return cache[arch]
    return get


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _spec(arch: str, reduced: bool):
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    return cfg, flat.spec_of(common.meta_tree(build(cfg).param_shapes(cfg)))


def _expected_dim(cfg, path: tuple, shape: tuple, M: int):
    """The split dim the dense family's rules give a leaf, written out:
    the vocab dim of ``embed`` / ``lm_head``, the ffn dim of the MLP, the
    head dim of the attention where whole kv groups divide; else None."""
    if cfg.family != "dense":
        return None
    name = "/".join(str(k) for k in path)
    nd = len(shape)
    heads = cfg.n_kv_heads % M == 0
    table = {"embed": (nd - 2, True), "lm_head": (nd - 1, True),
             "attn/wq": (nd - 1, heads), "attn/wk": (nd - 1, heads),
             "attn/wv": (nd - 1, heads), "attn/wo": (nd - 2, heads),
             "mlp/w_gate": (nd - 1, True), "mlp/w_up": (nd - 1, True),
             "mlp/w_down": (nd - 2, True)}
    for key, (dim, ok) in table.items():
        if name == key or name.endswith("/" + key):
            return dim if ok and shape[dim] % M == 0 else None
    return None


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_for_every_arch(arch, M, reduced):
    """Which leaves the model axis splits, for all ten archs at M = 2 and
    4, full and reduced: the dense family's vocab, ffn and (where
    ``n_kv_heads % M == 0``) attention leaves; the norms, the qk-norm
    gains and every leaf of the other families whole.  smollm-360m (5 kv
    heads) keeps its attention whole at both sizes, although its
    960-wide ``wq`` divides."""
    cfg, spec = _spec(arch, reduced)
    plan = partition.tensor_plan(cfg, spec, size=M)
    assert plan.size == M and len(plan.dims) == len(spec.leaves)
    want = tuple(_expected_dim(cfg, p, ls.shape, M)
                 for p, ls in zip(spec.paths, spec.leaves))
    assert plan.dims == want
    rec = partition.plan_record(spec, plan)
    assert rec["split_leaves"] + rec["whole_leaves"] == len(spec.leaves)
    assert len(rec["whole"]) == rec["whole_leaves"]
    if cfg.family == "dense":
        assert plan.split
        attn = [d for p, d in zip(spec.paths, plan.dims)
                if "/".join(map(str, p[-2:])) in LAYERS]
        split_attn = cfg.n_kv_heads % M == 0
        assert all((d is not None) == split_attn for d in attn), attn
        if arch == "smollm-360m" and not reduced:
            assert not split_attn and cfg.n_heads * 64 % M == 0
        if arch == "qwen3-4b" and not reduced:
            assert split_attn
    else:
        assert not plan.split


def test_plan_follows_the_logical_table():
    """The logical table that maps the tensor axes to None gives a plan
    with no split leaf (the reference's own switch); heads alone on the
    model axis split no attention leaf (q and k must split together)."""
    cfg, spec = _spec("qwen3-4b", True)
    try:
        partition.activate_mesh(None, logical=world_mod.WHOLE_MODEL)
        assert not partition.tensor_plan(cfg, spec, size=2).split
        partition.activate_mesh(None, logical={"kv_heads": None})
        plan = partition.tensor_plan(cfg, spec, size=2)
        assert plan.split and all(
            d is None for p, d in zip(spec.paths, plan.dims)
            if "/".join(map(str, p[-2:])) in LAYERS)
    finally:
        partition.activate_mesh(None)
    assert partition.tensor_plan(cfg, spec, size=1).dims == \
        (None,) * len(spec.leaves)


# ---------------------------------------------------------------------------
# the column <-> tensor maps
# ---------------------------------------------------------------------------

def _stress_plan(spec, M: int):
    """Every leaf split on its first dim that divides by M (the maps'
    arithmetic on every dim position)."""
    dims = []
    for ls in spec.leaves:
        ok = [d for d, s in enumerate(ls.shape) if s % M == 0]
        dims.append(ok[len(ok) // 2] if ok else None)
    return partition.TensorPlan(tuple(dims), M)


def _round_trip(spec, plan, split):
    """The maps of every rank, their collectives played in this process:
    each rank's tensor-local buffer against each leaf's slice, and the
    columns back from the local buffers, bit for bit."""
    M = plan.size
    x = torch.randn(spec.d, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    lays = [flat.TensorLayout(spec, flat.Columns(split, *split.block(r)),
                              plan, r) for r in range(M)]
    packs = [lays[r].pack_tensor(x[slice(*split.block(r))].clone())
             for r in range(M)]
    locals_ = []
    for t in range(M):
        recv = [packs[q][0][sum(lays[q]._send_t_counts[:t]):][
            :lays[q]._send_t_counts[t]] for q in range(M)]
        full = torch.cat([packs[q][1] for q in range(M)])
        locals_.append(lays[t].unpack_tensor(torch.cat(recv), full))
        want = []
        for i, ls in enumerate(spec.leaves):
            leaf = x[ls.offset:ls.offset + ls.size].reshape(ls.shape)
            if plan.dims[i] is not None:
                c = ls.shape[plan.dims[i]] // M
                leaf = leaf.narrow(plan.dims[i], t * c, c)
            want.append(leaf.reshape(-1))
        assert_bits_equal(locals_[t], torch.cat(want))
        assert locals_[t].shape[0] == lays[t].spec.d
    sends = [lays[t].pack_columns(locals_[t]) for t in range(M)]
    back = []
    for r in range(M):
        recv = [sends[t][sum(lays[t]._send_c_counts[:r]):][
            :lays[t]._send_c_counts[r]] for t in range(M)]
        back.append(lays[r].unpack_columns(
            locals_[r], torch.cat(recv),
            torch.empty(lays[r].cols.width, dtype=x.dtype)))
    assert_bits_equal(torch.cat(back), x)


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_maps_round_trip(arch, M):
    """For every arch's reduced spec, on the column split of a pallas top-k
    round over M model ranks: the arch's own plan (M = 2 and 4) and a plan
    that splits every leaf on a dim that divides (every M): the columns go
    into each rank's tensor-local buffer and come back, bit for bit."""
    cfg, spec = _spec(arch, True)
    fed = FedConfig(comm="pallas", uplink=CompressorConfig(kind="topk"),
                    downlink=CompressorConfig(kind="quant", bits=4))
    split = flat.column_split(spec, flat.flat_transports_for(fed, spec), M)
    plans = [_stress_plan(spec, M)]
    if M != 3:
        plans.append(partition.tensor_plan(cfg, spec, size=M))
    for plan in plans:
        _round_trip(spec, plan, split)


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-4b", "minitron-4b",
                                  "gemma3-4b"])
def test_maps_count_every_element_at_full_size(arch, M):
    """At the full published sizes (no data: the counts alone), every
    element a rank sends is one another rank expects, and each rank's
    tensor-local buffer is filled exactly once."""
    cfg, spec = _spec(arch, False)
    plan = partition.tensor_plan(cfg, spec, size=M)
    split = flat.column_split(spec, (), M)
    lays = [flat.TensorLayout(spec, flat.Columns(split, *split.block(r)),
                              plan, r) for r in range(M)]
    for t in range(M):
        assert [lays[q]._send_t_counts[t] for q in range(M)] == \
            lays[t]._recv_t_counts
        assert [lays[q]._send_c_counts[t] for q in range(M)] == \
            lays[t]._recv_c_counts
        filled = sum(n for _, _, n in lays[t]._recv_t) + sum(
            n for _, _, n in lays[t]._whole_place)
        assert filled == lays[t].spec.d
    assert sum(lay.spec.d for lay in lays) < M * spec.d


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_collectives_against_one_process(worlds, shape):
    """"g" (the sum, identity backward), "f" (the identity, summed
    backward) and the MAX reduce (no gradient) give one process's values
    and gradients bit for bit on every rank."""
    for r, res in enumerate(worlds(shape)):
        assert all(res["collectives"].values()), (r, res["collectives"])


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_vocab_parallel_cross_entropy(worlds, shape):
    """The CE of each rank's vocab block (with either mask, and none)
    against ``common.cross_entropy`` on the whole logits: the value within
    rtol 1e-6, the block's gradient within rtol 1e-6 / atol 1e-9."""
    for res in worlds(shape):
        for got, want, grad, want_grad in res["ce"]:
            np.testing.assert_allclose(n(got), n(want), rtol=1e-6)
            np.testing.assert_allclose(n(grad), n(want_grad), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("arch", list(world_mod.TP_ARCHS))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_forward_loss_and_grad(worlds, single, reference, shape, arch):
    """One loss pair under the split plan: the weights' tensor layout equal
    to each leaf's slice; the logits (gathered over the vocab blocks), f,
    g and the gradient of f (mapped back to the columns and gathered)
    against one process and the reference (module docstring's
    tolerances); f, g and the whole leaves' gradients the same bits on
    every rank."""
    one, ref = single("forward", arch), reference(arch)
    ranks = worlds(shape)
    for r, res in enumerate(ranks):
        got = res["forward"][arch]
        assert got["layout_exact"], r
        assert any(d is not None for d in got["plan"])
        np.testing.assert_allclose(n(got["logits"]), n(one["logits"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose([float(got["f"]), float(got["g"])],
                                   [float(one["f"]), float(one["g"])],
                                   rtol=1e-5)
        np.testing.assert_allclose(n(got["grad"]), n(one["grad"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(n(got["logits"]), ref["logits"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose([float(got["f"]), float(got["g"])],
                                   [ref["f"], ref["g"]], rtol=1e-5)
        np.testing.assert_allclose(n(got["grad"]), ref["grad"], rtol=1e-4,
                                   atol=1e-6)
        assert got["sha1"] == ranks[0]["forward"][arch]["sha1"], r


@pytest.mark.parametrize("name", list(world_mod.TP_CASES))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_rounds_under_split_plan(worlds, single, shape, name):
    """Two rounds whose model ranks share every client's forward and
    backward: the uncompressed wire (fused eval, remat on; gather with the
    separate eval, remat off), pallas top-k up and down in gather mode
    (the separate eval) and on gemma3's patterned stack, pallas quant
    with remat off and on smollm (attention whole): every rank's state
    and metrics against one process by the module docstring's law."""
    want = single("case", name)
    exact = world_mod.TP_CASES[name][1][-1] == "none"
    for r, res in enumerate(worlds(shape)):
        got = dict(res["cases"][name])
        assert got.pop("split_plan"), name
        try:
            world_mod.tp_law(got, {k: v for k, v in want.items()
                                   if k != "split_plan"}, exact)
        except AssertionError as err:
            raise AssertionError(f"{MESH_IDS[shape]} rank {r}: {err}") \
                from None


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_ranks_bit_equal(worlds, shape):
    """Every rank of a world ends every case with the same bits: its
    gathered state (w, x, the averaged-iterate sums, the residual) and
    every metric (f, g, sigma, the wire bytes)."""
    ranks = worlds(shape)
    for r, res in enumerate(ranks):
        assert res["digests"] == ranks[0]["digests"], r


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_whole_model_table_bit_equal(worlds, single, shape):
    """Under the logical table that keeps the models whole (no split leaf)
    a round is one process's, bit for bit (the model on every rank, the
    flat state by columns)."""
    want = dict(single("case", world_mod.TP_WHOLE_CASE))
    want.pop("split_plan")
    for res in worlds(shape):
        got = dict(res["whole_case"])
        assert not got.pop("split_plan")
        assert got.keys() == want.keys()
        for key, v in want.items():
            if isinstance(v, torch.Tensor):
                assert_bits_equal(got[key], v)
            else:
                assert got[key] == v, key


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS.get)
def test_model_axis_carries_the_layers(worlds, shape):
    """The model axis's group carries the layers' traffic (the exchanges,
    "f", "g") in every world; the client axis's only where it holds two
    or more ranks."""
    for res in worlds(shape):
        by = res["collectives_by_axis"]
        assert by["model"]["calls"] > 0 and by["model"]["bytes_out"] > 0
        assert (by["client"]["calls"] > 0) == (shape[0] > 1)

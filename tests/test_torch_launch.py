"""The launch tooling against the JAX package: the sharding rules and spec
trees, the case policy (``fed_config_for``, the logical tables,
``skip_reason``, MODEL_FLOPS), and the dry run on ``meta`` tensors.

The reference's spec side needs no devices: ``activate_mesh`` and
``make_specs`` read only a mesh's ``axis_names`` and ``devices.shape``
(``src/repro/sharding/partition.py:37-62,166-176``), so a stand-in object
with those two attributes takes the place of a ``jax.sharding.Mesh``.
The shapes are ``jax.eval_shape`` of the reference's ``init`` of the full
configs.  Every comparison is exact: specs as tuples leaf for leaf on the
same tree, configs field for field, FLOPs as floats.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jax_configs
from repro.launch import roofline as jax_roofline
from repro.launch import steps as jax_steps
from repro.models import build as jax_build
from repro.sharding import partition as jax_partition
from repro_torch import configs, kernels, resolve_device
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, mesh, roofline, steps, train
from repro_torch.models import build
from repro_torch.sharding import partition
from torch_port_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = jax_configs.all_arch_names()
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model"))]
MESH_IDS = ["single", "multi", "debug"]


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.fixture
def no_mesh():
    """Both packages' logical tables restored after the test."""
    yield
    jax_partition.activate_mesh(None)
    partition.activate_mesh(None)


def _assert_same_specs(got, want, path="") -> None:
    if isinstance(want, P):
        assert isinstance(got, tuple) and got == tuple(want), \
            (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_specs(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(want, (list, tuple)), (path, type(want))
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_specs(a, b, f"{path}/{i}")


def _activate_both(kind, jcfg, cfg, stand, pmesh):
    if kind == "default":
        jax_partition.activate_mesh(stand)
        partition.activate_mesh(pmesh)
        return
    jfed = jax_steps.fed_config_for(jcfg, stand) if kind == "train" else None
    fed = steps.fed_config_for(cfg, pmesh) if kind == "train" else None
    jax_steps._activate(jcfg, stand, kind, jfed)
    steps._activate(cfg, pmesh, kind, fed)


# ---------------------------------------------------------------------------
# rules and spec trees
# ---------------------------------------------------------------------------

def test_rules_match_reference():
    """The five rule lists, regex for regex, for every config (the giants'
    ``fsdp`` included)."""
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
        assert build(cfg).param_rules == jax_build(jcfg).param_rules, arch


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, shape, axes, no_mesh):
    """``make_specs(param_shapes, param_rules)`` of the full config equals
    the reference's ``make_specs`` of ``jax.eval_shape(init)``, under the
    default logical table and under the train and serve tables of
    ``steps._activate``; ``named_shardings`` puts each spec on the mesh."""
    jcfg, cfg = jax_configs.get_config(arch), configs.get_config(arch)
    jfns, fns = jax_build(jcfg), build(cfg)
    shapes = jax.eval_shape(lambda k: jfns.init(k, jcfg),
                            jax.random.PRNGKey(0))
    stand, pmesh = _stand_in(shape, axes), mesh.make_debug_mesh(shape, axes)
    for kind in ("default", "train", "serve"):
        _activate_both(kind, jcfg, cfg, stand, pmesh)
        want = jax_partition.make_specs(shapes, jfns.param_rules)
        got = partition.make_specs(fns.param_shapes(cfg), fns.param_rules)
        _assert_same_specs(got, want, kind)
    named = partition.named_shardings(got, pmesh)
    assert named["embed"] == partition.NamedSharding(pmesh, got["embed"])


def test_activate_mesh_remaps_and_drops_axes(no_mesh):
    """With a mesh, ``client_axis`` becomes the client axis and logical
    axes on absent mesh axes are dropped; ``check_divisible`` and
    ``sharding_for`` read the mesh's sizes, as the reference's do."""
    for shape, axes in MESHES:
        stand, pmesh = _stand_in(shape, axes), mesh.make_debug_mesh(shape,
                                                                    axes)
        for kw in ({}, {"client_axis": "pod"},
                   {"logical": {"batch": ("pod", "data")},
                    "client_axis": "data"}):
            jax_partition.activate_mesh(stand, **kw)
            partition.activate_mesh(pmesh, **kw)
            assert partition._LOGICAL == jax_partition._LOGICAL
            for names, dims in ((("client", "flat"), (32, 4096)),
                                (("batch", "vocab"), (4, 50280)),
                                (("experts", None, "ffn"), (160, 3, 1536))):
                want = jax_partition.check_divisible(
                    jax_partition.resolve(*names), dims)
                assert partition.check_divisible(
                    partition.resolve(*names), dims) == tuple(want)
            # the reference's NamedSharding of this spec needs real devices
            assert partition.sharding_for("heads") == \
                partition.NamedSharding(pmesh, tuple(
                    jax_partition.resolve("heads")))
    assert partition.current_mesh() is pmesh


# ---------------------------------------------------------------------------
# the case policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_case_policy_matches_reference(arch, no_mesh):
    """``fed_config_for`` field for field (default and a pallas, full,
    gather, async, obs variant), the logical tables after
    ``steps._activate`` for train and serve, ``skip_reason`` and
    MODEL_FLOPS (train and forward) for every input shape."""
    jcfg, cfg = jax_configs.get_config(arch), configs.get_config(arch)
    variant = dict(comm="pallas", partial=False, participation="gather",
                   async_buffer=True, staleness="poly", obs=True,
                   local_steps=2, uplink_ratio=0.05)
    for shape, axes in MESHES:
        stand, pmesh = _stand_in(shape, axes), mesh.make_debug_mesh(shape,
                                                                    axes)
        for kw in ({}, variant):
            assert dataclasses.asdict(steps.fed_config_for(cfg, pmesh, **kw)) \
                == dataclasses.asdict(jax_steps.fed_config_for(jcfg, stand,
                                                               **kw))
        for kind in ("train", "serve"):
            _activate_both(kind, jcfg, cfg, stand, pmesh)
            assert partition._LOGICAL == jax_partition._LOGICAL, kind
    for name, shape in INPUT_SHAPES.items():
        assert steps.skip_reason(arch, name) == \
            jax_steps.skip_reason(arch, name)
        n_tok = shape.global_batch * shape.seq_len
        assert roofline.model_flops(cfg, n_tok) == \
            jax_roofline.model_flops(jcfg, n_tok)
        assert roofline.model_flops_forward(cfg, n_tok) == \
            jax_roofline.model_flops_forward(jcfg, n_tok)
    assert steps._strip_axis(("pod", ("pod", "data"), "model", None),
                             "pod") == \
        tuple(jax_steps._strip_axis(P("pod", ("pod", "data"), "model", None),
                                    "pod"))


def test_skips_are_the_seven_full_attention_archs():
    """long_500k is skipped for every arch that is not sub-quadratic
    (whisper among them): 14 of the sweep's 80 records."""
    skipped = [a for a in ARCHS for s in INPUT_SHAPES
               if steps.skip_reason(a, s)]
    assert len(skipped) == 7
    assert {a for a in ARCHS if configs.get_config(a).sub_quadratic} == \
        {"gemma3-4b", "mamba2-130m", "recurrentgemma-2b"}


def test_roofline_terms_on_the_h100():
    """The compute term takes the peak of the case's dtype; with no
    collective bytes the collective term is None and never dominates."""
    t = roofline.roofline_terms(67e12, 3.35e12, None, 1, dtype="float32")
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    assert t["collective_s"] is None and t["dominant"] in ("compute",
                                                           "memory")
    t = roofline.roofline_terms(989e12, 0.0, 9e11, 256, dtype="bfloat16")
    assert t["compute_s"] == 1.0 and t["collective_s"] == 1.0
    coll = {"total": 100, "in_loop": 30}
    assert roofline.corrected_collective_bytes(coll, 4) == \
        jax_roofline.corrected_collective_bytes(coll, 4)


# ---------------------------------------------------------------------------
# meshes, the launcher's --multi-pod, the meta device
# ---------------------------------------------------------------------------

def test_production_mesh_needs_its_devices(no_mesh):
    """The production meshes' shapes over placeholder devices; over the
    CUDA devices present (none here) the reference's RuntimeError; the
    launcher's ``--multi-pod`` raises it too."""
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = mesh.make_production_mesh(
            multi_pod=multi, devices=mesh.placeholder_devices(512))
        assert m.devices.shape == shape and m.size == int(np.prod(shape))
        with pytest.raises(RuntimeError, match="devices but only"):
            mesh.make_production_mesh(multi_pod=multi,
                                      devices=mesh.placeholder_devices(8))
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        train.main(["--multi-pod", "--reduced", "--device", "cpu",
                    "--rounds", "1", "--quiet"])
    assert mesh.make_debug_mesh().devices.shape == (2, 2)


def test_meta_device_shapes_only():
    """``resolve_device("meta")`` for the dry run (``cuda`` stays every
    entry point's default); each kernel wrapper gives meta tensors the
    plain version's shapes and dtypes and launches nothing."""
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 64, generator=gen)
    words = torch.randint(0, 2 ** 16, (3, 4, 16), generator=gen,
                          dtype=torch.int64).to(torch.uint32)
    idx = torch.randint(0, 64, (3, 4, 8), generator=gen).to(torch.uint16)
    w = torch.rand(3, generator=gen)
    calls = [
        ("block_topk", lambda a: ops_call("block_topk", a[0], 8), (x,)),
        ("scatter_agg", lambda a: ops_call("scatter_agg", a[0], a[1], a[2],
                                           64), (x[..., :8], idx, w)),
        ("quantize_ef_pack", lambda a: ops_call("quantize_ef_pack", a[0],
                                                a[1], 8), (x, x)),
        ("unpack_mma", lambda a: ops_call("unpack_mma", a[0],
                                          a[1][..., 0], a[2], 8, 64),
         (words, x, w)),
        ("segment_rows", lambda a: ops_call(
            "segment_rows", a[0], a[1], 5), (x[0], torch.tensor(
                [0, 2, 2, 7]))),
        ("quantize_ef", lambda a: ops_call("quantize_ef", a[0], a[1], 8),
         (x[0], x[0])),
        ("switch_blend", lambda a: ops_call("switch_blend", a[0], a[1],
                                            a[2]),
         (x.reshape(-1), x.reshape(-1), torch.tensor([0.25]))),
    ]
    kernels.reset_launches()
    for name, fn, args in calls:
        want = fn(args)
        got = fn(tuple(a.to("meta") for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(g.device.type, g.shape, g.dtype) for g in got] == \
            [("meta", v.shape, v.dtype) for v in want], name
    assert not any(kernels.launch_counts().values())


def ops_call(name, *args):
    from repro_torch.kernels import (quantize_ef, quantize_ef_pack,
                                     scatter_agg, switch_blend, topk_block,
                                     unpack_mma)
    fn = {"block_topk": topk_block.block_topk,
          "scatter_agg": scatter_agg.scatter_agg,
          "segment_rows": scatter_agg.segment_rows,
          "quantize_ef_pack": quantize_ef_pack.quantize_ef_pack,
          "unpack_mma": unpack_mma.unpack_mma,
          "quantize_ef": quantize_ef.quantize_ef,
          "switch_blend": switch_blend.switch_blend}[name]
    return fn(*args)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_cli_decode_32k():
    """``python -m repro_torch.launch.dryrun --arch smollm-360m --shape
    decode_32k --mesh single`` exits 0 within 60 s and prints the memory
    and roofline lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "decode_32k", "--mesh", "single"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert time.time() - t0 < 60
    assert "memory per device: arguments" in out.stdout
    assert "roofline (H100): compute=" in out.stdout


def _spec_bytes(tree, specs, sizes, seen):
    """Independent of ``steps.tree_bytes``: numel * itemsize over the
    product of the spec's mesh-axis sizes, each distinct tensor once."""
    if isinstance(tree, torch.Tensor):
        if id(tree) in seen:
            return 0
        seen.add(id(tree))
        div = 1
        for e in specs or ():
            for a in (e if isinstance(e, tuple) else (e,)):
                div *= sizes.get(a, 1) if a is not None else 1
        return tree.numel() * tree.element_size() // div
    if isinstance(tree, dict):
        return sum(_spec_bytes(v, specs[k], sizes, seen)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_spec_bytes(v, None if specs is None else specs[i],
                               sizes, seen) for i, v in enumerate(tree))
    return 0


FAMILY_ARCHS = ["smollm-360m", "mamba2-130m", "recurrentgemma-2b",
                "deepseek-v2-236b", "llama-3.2-vision-90b", "whisper-small"]


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_run_one_reduced_each_family(arch, shape_name, monkeypatch,
                                     no_mesh):
    """``run_one`` on the reduced config of each family (single mesh):
    ``ok``, and its argument bytes are the sum over the case's spec'd
    shapes; the count equals ``FlopCounterMode``'s on the same case."""
    monkeypatch.setattr(configs, "get_config", configs.get_reduced)
    rec = dryrun.run_one(arch, shape_name, "single", verbose=False)
    assert rec["status"] == "ok", rec
    m = mesh.make_production_mesh(devices=mesh.placeholder_devices(256))
    case = steps.build_case(arch, shape_name, m)
    want = _spec_bytes(case.args, case.specs, dict(zip(m.axis_names,
                                                       m.devices.shape)),
                       set())
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["cost"]["flops"] * 256 == rec["cost"]["flops_counted"] > 0
    if arch == "smollm-360m":
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter, (torch.enable_grad() if shape_name == "train_4k"
                       else torch.no_grad()):
            case.fn(*steps.build_case(arch, shape_name, m).args)
        assert counter.get_total_flops() == rec["cost"]["flops_counted"]

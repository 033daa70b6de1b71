"""Observability of the port (``repro_torch.obs``) against the JAX package,
on the CPU, at the NP size of ``tests/test_obs.py`` (N = 8 clients, m = 4,
E = 2).

* telemetry on is observation only: state and every shared metric
  bit-equal to telemetry off, sync and async;
* telemetry against ``repro.obs.bus`` on the same recorded cohorts (and,
  async, the reference's own event uniforms): the norms and ratios at rtol
  1e-5 (reductions over d in another order), the margin, switch fraction,
  buffer counters and wire bytes at rtol 1e-6;
* the trailing switch fraction against a host replay, the staleness
  histogram against the buffer counters, the drive loops' progress and
  ``on_chunk`` hooks, metric segments;
* the sinks: the JSONL records' schema equal to the reference's, the
  stdout sink's line and ``--quiet`` equal to the reference's, log levels;
* ``ProfileWindow``: bad specs rejected, a CPU capture holding the stage
  spans.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ObsConfig as JObsConfig
from repro.engine import async_rounds as jax_async
from repro.engine import rounds as jax_rounds
from repro.fleet import samplers as jax_samplers
from repro.obs import log as jax_log
from repro.obs import sinks as jax_sinks
from repro.tasks import np_classification as jax_npc
from repro_torch.configs.base import ObsConfig
from repro_torch.engine import async_rounds, rounds
from repro_torch.fleet import samplers
from repro_torch.obs import bus, log as obs_log, sinks, trace
from repro_torch.tasks import np_classification as npc
from test_torch_async import (ReplayEvents, _async, _batch, _cfgs,
                              _params, cohorts, reference_event_uniforms)
from torch_port_util import assert_bits_equal, n

EPS = 0.35
N, M = 8, 4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def np_data():
    (xs, ys), _ = jax_npc.make_dataset(jax.random.PRNGKey(0), n_clients=N)
    return np.asarray(xs), np.asarray(ys)


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setitem(samplers._SAMPLERS, ReplayEvents.name, ReplayEvents)
    monkeypatch.setattr(ReplayEvents, "UNIFORMS", [])
    return ReplayEvents


def _obs(cfg, window=4):
    return cfg.replace(obs=ObsConfig(enabled=True, window=window))


def _drive(cfg, np_data, T=3, block=0, **kw):
    state = rounds.init_state(_params(), cfg, device="cpu")
    if cfg.async_.enabled:
        state, buf, mets = async_rounds.async_drive(
            state, _batch(np_data), npc.loss_pair, cfg, T, device="cpu",
            block=block, **kw)
        return (state, buf), mets, mets.round
    state, mets = rounds.drive(state, _batch(np_data), npc.loss_pair, cfg,
                               T, device="cpu", block=block, **kw)
    return (state, None), mets, mets


def _flat(x):
    """Every tensor / array of a (nested) state, buffer or metric record,
    None fields skipped."""
    if x is None:
        return []
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return [x]
    if isinstance(x, (int, float)):
        return [np.asarray(x)]
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _flat(v)]
    return []


def _strip_tel(mets, rm):
    if mets is rm:
        return mets._replace(telemetry=None)
    return mets._replace(round=mets.round._replace(telemetry=None))


# ---------------------------------------------------------------------------
# Observation only
# ---------------------------------------------------------------------------

PARITY_CASES = {
    "fedsgm topk mask sync": dict(strategy="fedsgm", up="topk",
                                  participation="mask"),
    "fedsgm quant4 gather sync": dict(strategy="fedsgm", up="quant4",
                                      down="quant", participation="gather"),
    "penalty none mask sync": dict(strategy="penalty-fedavg", up="none",
                                   participation="mask"),
    "soft topk gather async": dict(strategy="fedsgm-soft", up="topk",
                                   participation="gather",
                                   async_=_async(max_staleness=3,
                                                 depart=0.3)),
    "fedsgm quant4 mask async": dict(strategy="fedsgm", up="quant4",
                                     participation="mask",
                                     async_=_async(max_staleness=2,
                                                   depart=0.3)),
}


def _case_cfg(case):
    return _cfgs(**PARITY_CASES[case])[1]


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_enabled_is_observation_only(np_data, case):
    cfg_off = _case_cfg(case)
    carry0, mets0, rm0 = _drive(cfg_off, np_data, T=3, block=2)
    carry1, mets1, rm1 = _drive(_obs(cfg_off), np_data, T=3, block=2)
    assert rm0.telemetry is None
    assert isinstance(rm1.telemetry, bus.Telemetry)
    (s0, b0), (s1, b1) = carry0, carry1
    for a, b in zip(_flat((s0.w, s0.x, s0.e_up, s0.wbar_sum, s0.t, b0)),
                    _flat((s1.w, s1.x, s1.e_up, s1.wbar_sum, s1.t, b1))):
        assert_bits_equal(a, b)
    for a, b in zip(_flat(_strip_tel(mets0, rm0)),
                    _flat(_strip_tel(mets1, rm1))):
        assert_bits_equal(a, b)


def test_margin_and_wire_bytes_match_metrics(np_data):
    cfg = _obs(_cfgs(up="topk", down="quant")[1])
    _, _, rm = _drive(cfg, np_data, T=4)
    tel = rm.telemetry
    np.testing.assert_array_equal(tel.margin, rm.g_hat - np.float32(EPS))
    np.testing.assert_array_equal(tel.wire_up_bytes, rm.up_bytes * cfg.m)
    np.testing.assert_array_equal(tel.wire_down_bytes, rm.down_bytes)
    for leaf in tel:
        assert np.isfinite(leaf).all()
    assert (tel.slot_occupancy == 0).all()


# ---------------------------------------------------------------------------
# Telemetry against the reference
# ---------------------------------------------------------------------------

TEL_CASES = {
    "sync topk mask": dict(up="topk", participation="mask"),
    "sync quant gather, quant down": dict(up="quant", down="quant",
                                          participation="gather",
                                          comm="pallas"),
    "async topk gather constraint": dict(
        up="topk", participation="gather", comm="pallas",
        async_=_async(staleness="constraint", max_staleness=2, depart=0.5,
                      rejoin=0.4)),
    "async quant mask poly": dict(
        up="quant", down="quant", participation="mask", comm="packed",
        async_=_async(staleness="poly", max_staleness=2, depart=0.5,
                      rejoin=0.4)),
}
TEL_REL = {"up_res_norm": 1e-5, "up_ratio": 1e-5, "down_err_norm": 1e-5,
           "down_ratio": 1e-5}


@pytest.mark.parametrize("case", sorted(TEL_CASES))
def test_telemetry_matches_reference(np_data, replay, case):
    T, W = 5, 3
    jcfg, cfg = _cfgs(fleet=dict(sampler="fixed"), **TEL_CASES[case])
    jcfg = jcfg.replace(obs=JObsConfig(enabled=True, window=W))
    cfg = cfg.replace(obs=ObsConfig(enabled=True, window=W))
    masks, weights = cohorts(T)
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    jstate = jstate._replace(sampler=jax_samplers.fixed_state(
        jnp.asarray(masks), jnp.asarray(weights)))
    data = (jnp.asarray(np_data[0]), jnp.asarray(np_data[1]))
    state = rounds.init_state(_params(), cfg, device="cpu")
    state = state._replace(sampler=samplers.fixed_state(masks, weights))
    if cfg.async_.enabled:
        _, _, jh = jax_async.async_drive(jstate, data, jax_npc.loss_pair,
                                         jcfg, T)
        replay.UNIFORMS = reference_event_uniforms(cfg.seed, T)
        cfg = cfg.replace(fleet=dataclasses.replace(cfg.fleet,
                                                    sampler=replay.name))
        _, _, h = async_rounds.async_drive(state, _batch(np_data),
                                           npc.loss_pair, cfg, T,
                                           device="cpu")
        jtel, tel = jh.round.telemetry, h.round.telemetry
        assert float(h.departed.sum()) > 0
    else:
        _, jh = jax_rounds.drive(jstate, data, jax_npc.loss_pair, jcfg, T)
        _, h = rounds.drive(state, _batch(np_data), npc.loss_pair, cfg, T,
                            device="cpu")
        jtel, tel = jh.telemetry, h.telemetry
    assert tel._fields == jtel._fields
    for f in tel._fields:
        want = np.asarray(getattr(jtel, f))
        got = getattr(tel, f)
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=TEL_REL.get(f, 1e-6),
                                   atol=1e-7, err_msg=f)


def test_residual_norm_matches_reference():
    from repro.obs import bus as jax_bus
    rng = np.random.default_rng(1)
    e = rng.standard_normal((5, 1000)).astype(np.float32)
    np.testing.assert_allclose(n(bus.residual_norm(torch.from_numpy(e))),
                               np.asarray(jax_bus.residual_norm(
                                   jnp.asarray(e))), rtol=1e-6)
    assert float(bus.residual_norm(None)) == 0.0


@pytest.mark.parametrize("w", [1, 3, 8])
def test_switch_window_matches_host_replay(np_data, w):
    cfg = _obs(_cfgs(up="topk")[1], window=w)
    cfg = cfg.replace(switch=dataclasses.replace(cfg.switch, mode="soft",
                                                 beta=10.0))
    _, mets, rm = _drive(cfg, np_data, T=6, block=2)
    sig = np.asarray(mets.sigma, np.float64)
    want = [sig[max(0, t - w + 1):t + 1].sum() / min(t + 1, w)
            for t in range(len(sig))]
    np.testing.assert_allclose(rm.telemetry.switch_frac, want, rtol=1e-6)


def test_staleness_hist_accounts_for_every_parked_entry(np_data):
    _, cfg = _cfgs(up="topk", participation="gather",
                   fleet=dict(sampler="markov"),
                   async_=_async(max_staleness=3, depart=0.4))
    _, ah, rm = _drive(_obs(cfg), np_data, T=8, block=4)
    hist = rm.telemetry.buf_stale_hist
    assert hist.shape == (8, cfg.async_.max_staleness + 1)
    np.testing.assert_array_equal(hist.sum(axis=1), ah.occupancy)
    np.testing.assert_array_equal(rm.telemetry.buf_occupancy, ah.occupancy)
    np.testing.assert_array_equal(rm.telemetry.buf_parked_weight,
                                  ah.buffered_weight)
    for t in range(hist.shape[0]):
        if hist[t].sum() > 0:
            assert int(np.nonzero(hist[t])[0].max()) == int(ah.max_age[t])
    assert hist.sum() > 0


def test_staleness_hist_zero_in_sync_rounds(np_data):
    _, _, rm = _drive(_obs(_cfgs(up="topk")[1]), np_data, T=3)
    assert (rm.telemetry.buf_stale_hist == 0).all()
    assert (rm.telemetry.buf_occupancy == 0).all()


# ---------------------------------------------------------------------------
# Drive-loop hooks and metric segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_on", [False, True])
def test_progress_is_ordered(np_data, async_on):
    seen = []
    _, cfg = _cfgs(up="topk", async_=_async(depart=0.3) if async_on
                   else None)
    _drive(_obs(cfg, window=2), np_data, T=6, block=4,
           progress=lambda t, f, g, s: seen.append(
               (t, float(f), float(g), float(s))))
    assert [s[0] for s in seen] == list(range(1, 7))
    assert all(np.isfinite(s[1]) for s in seen)


def test_on_chunk_delivers_block_segments(np_data):
    chunks = []
    _, mets, _ = _drive(_obs(_cfgs(up="topk")[1], window=2), np_data, T=5,
                        block=2, on_chunk=chunks.append)
    assert [len(c.f) for c in chunks] == [2, 2, 1]
    np.testing.assert_array_equal(np.concatenate([c.f for c in chunks]),
                                  mets.f)
    assert all(c.telemetry.switch_frac.shape == (len(c.f),) for c in chunks)


def test_async_block_offload_equal(np_data):
    _, cfg = _cfgs(up="quant", async_=_async(depart=0.4))
    (s1, b1), h1, _ = _drive(cfg, np_data, T=5)
    (s2, b2), h2, _ = _drive(cfg, np_data, T=5, block=2)
    for a, b in zip(_flat((s1.w, s1.e_up, b1, h1)),
                    _flat((s2.w, s2.e_up, b2, h2))):
        assert_bits_equal(a, b)


# ---------------------------------------------------------------------------
# Sinks and the log
# ---------------------------------------------------------------------------

def test_sink_registry():
    assert sinks.sink_names() == jax_sinks.sink_names() == \
        ("jsonl", "memory", "stdout")
    with pytest.raises(ValueError, match="unknown metrics sink"):
        sinks.get_sink("nope")


@pytest.mark.parametrize("kind", ["sync", "sync obs", "async obs"])
def test_rows_schema_matches_reference(np_data, kind):
    """``rows`` gives the reference's keys in the reference's order, and
    the JSONL sink round-trips them (meta line first)."""
    obs = "obs" in kind
    async_ = _async(depart=0.4) if "async" in kind else None
    jcfg, cfg = _cfgs(up="topk", async_=async_)
    if obs:
        jcfg = jcfg.replace(obs=JObsConfig(enabled=True, window=2))
        cfg = _obs(cfg, window=2)
    jstate = jax_rounds.init_state(jax_npc.init_params(None, 30), jcfg)
    data = (jnp.asarray(np_data[0]), jnp.asarray(np_data[1]))
    if async_:
        _, _, jmets = jax_async.async_drive(jstate, data, jax_npc.loss_pair,
                                            jcfg, 2)
    else:
        _, jmets = jax_rounds.drive(jstate, data, jax_npc.loss_pair, jcfg,
                                    2)
    _, mets, _ = _drive(cfg, np_data, T=2)
    want = jax_sinks.rows(jmets, start_round=5, s_per_round=0.5)
    got = sinks.rows(mets, start_round=5, s_per_round=0.5)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["round"] for r in got] == [6, 7]
    for r, w in zip(got, want):
        for k, v in r.items():
            assert type(v) is type(w[k]), k
    if obs:
        assert isinstance(got[0]["tel_buf_stale_hist"], list)
    else:
        assert not any(k.startswith("tel_") for r in got for k in r)


def test_jsonl_round_trip(tmp_path, np_data):
    _, mets, _ = _drive(_obs(_cfgs(up="topk", async_=_async())[1]), np_data,
                        T=3)
    recs = sinks.rows(mets, start_round=5, s_per_round=0.5)
    path = tmp_path / "m.jsonl"
    sink = sinks.get_sink("jsonl", path=str(path))
    sink.open(meta={"arch": "np"})
    for r in recs:
        sink.emit(r)
    sink.close()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0] == {"meta": {"arch": "np"}}
    assert lines[1:] == recs
    mem = sinks.get_sink("memory")
    mem.open({"a": 1})
    for r in recs:
        mem.emit(r)
    assert mem.records == recs and mem.meta == {"a": 1}


def test_stdout_sink_and_quiet_match_reference(capsys):
    rec = {"round": 3, "f": 1.25, "g_hat": -0.5, "sigma": 1.0,
           "s_per_round": 0.1, "occupancy": 2.0, "merged": 1.0,
           "tel_margin": -0.85, "tel_switch_frac": 0.5,
           "tel_up_ratio": 0.25}
    old, jold = obs_log.get_level(), jax_log.get_level()
    try:
        for level in ("info", "warning"):
            obs_log.set_level(level)
            jax_log.set_level(level)
            sinks.get_sink("stdout").emit(rec)
            got = capsys.readouterr().out
            jax_sinks.get_sink("stdout").emit(rec)
            assert got == capsys.readouterr().out
            if level == "info":
                assert got == ("round    3: f=1.2500 g=-0.5000 sigma=1.00 "
                               "(0.10s/round) buffered=2 merged=1 "
                               "margin=-0.8500 switch=0.50 "
                               "ef_ratio=0.250\n")
            else:
                assert got == ""
    finally:
        obs_log.set_level(old)
        jax_log.set_level(jold)


def test_log_levels(capsys):
    assert obs_log.LEVELS == jax_log.LEVELS
    old = obs_log.get_level()
    try:
        obs_log.set_level("warning")
        obs_log.log("hidden")
        obs_log.log("shown", level="error")
        out = capsys.readouterr().out
        assert "hidden" not in out and "shown" in out
        with pytest.raises(ValueError, match="unknown log level"):
            obs_log.set_level("loud")
        with pytest.raises(ValueError, match="unknown log level"):
            obs_log.log("x", level="loud")
    finally:
        obs_log.set_level(old)


# ---------------------------------------------------------------------------
# Spans and the profile window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["10", "a:b", "1:2:3", "5:5", "6:2"])
def test_profile_window_rejects_bad_specs(spec):
    with pytest.raises(ValueError, match="--profile"):
        trace.ProfileWindow(spec)


def test_profile_window_disabled_is_a_no_op(tmp_path):
    win = trace.ProfileWindow(None, out_dir=str(tmp_path / "p"))
    win.tick(0)
    win.close()
    assert win.done and not win.active and win.path is None
    assert not (tmp_path / "p").exists()


def test_profile_window_captures_the_stage_spans(tmp_path, np_data):
    """A window over two of four rounds writes one Chrome trace holding the
    round, wire and kernel spans (the tree pallas top-k wire on the CPU
    runs the kernels' plain versions inside their spans)."""
    _, cfg = _cfgs(up="topk", down="topk", comm="pallas",
                   participation="gather", async_=_async(depart=0.5))
    state = rounds.init_state(_params(), _obs(cfg), device="cpu")
    buf = async_rounds.init_buffer(state, cfg)
    win = trace.ProfileWindow("1:3", out_dir=str(tmp_path / "prof"))
    for r in range(4):
        win.tick(r)
        assert win.active == (1 <= r < 3)
        state, buf, _ = async_rounds.async_round_step(
            state, buf, _batch(np_data), npc.loss_pair, _obs(cfg),
            device="cpu")
    win.close()
    assert win.done and win.path.endswith("trace_1_3.json")
    with open(win.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for span in ("round.sample_round", "round.eval_round",
                 "round.local_deltas", "round.encode", "round.reduce",
                 "round.server_update", "round.downlink", "round.telemetry",
                 "comm.ef_encode", "comm.reduce", "comm.broadcast",
                 "kernel.block_topk", "kernel.scatter_agg",
                 "kernel.segment_rows"):
        assert span in names, span

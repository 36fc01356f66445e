"""The port's per-rank observability planes held against the JAX package's.

The flight recorder, the metrics catalogue and its merge, the timeline, the
step profiler (ledger, roofline, watchdog), goodput (ledger, serving
goodput, journals and report) and the trace shard merger take the same
inputs, made with numpy from a seed, in both packages; timestamps, pids,
hosts and trace ids are left out of each comparison. Then the planes run
armed in the port's own worlds, started once in the module fixture
``worlds``: a data-parallel MLP at 1 and 2 ranks (conservation, flight
pairs, timeline spans against buckets, one step record per step, and
parameters bit-equal to a disarmed run), a 2-rank world where one rank
skips a collective (both analyzers name the same first unmatched
collective and straggler order over the port's dumps), and two 2 x 2
worlds of torus buckets, ``HOROVOD_CROSS_OVERLAP`` on and off.
"""

import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.flight import analyze as j_analyze
from horovod_tpu.flight import recorder as j_rec
from horovod_tpu.goodput import history as j_hist
from horovod_tpu.goodput import ledger as j_gp
from horovod_tpu.goodput import report as j_report
from horovod_tpu.metrics import instruments as j_metrics
from horovod_tpu.metrics import merge as j_merge
from horovod_tpu.profile import ledger as j_ledger
from horovod_tpu.profile import roofline as j_roof
from horovod_tpu.profile import watchdog as j_wd
from horovod_tpu.trace import analyze as j_tanalyze
from horovod_tpu import timeline as j_timeline

from horovod_tpu_torch.flight import analyze as p_analyze
from horovod_tpu_torch.flight import recorder as p_rec
from horovod_tpu_torch.goodput import history as p_hist
from horovod_tpu_torch.goodput import ledger as p_gp
from horovod_tpu_torch.goodput import report as p_report
from horovod_tpu_torch.metrics import instruments as p_metrics
from horovod_tpu_torch.metrics import merge as p_merge
from horovod_tpu_torch.profile import ledger as p_ledger
from horovod_tpu_torch.profile import roofline as p_roof
from horovod_tpu_torch.profile import watchdog as p_wd
from horovod_tpu_torch.trace import analyze as p_tanalyze
from horovod_tpu_torch import timeline as p_timeline

from torch_observe_helpers import desync, observed_dp, overlap_world
from torch_port_helpers import run_world_async

SEED = 18
STEPS = 4
_VOLATILE = ("t", "trace", "pid", "host", "boot", "ts")


def _strip(d):
    return {k: v for k, v in d.items() if k not in _VOLATILE}


@pytest.fixture(scope="module")
def worlds():
    tmp = tempfile.mkdtemp(prefix="hvd_observe_")
    dumps = os.path.join(tmp, "dumps")
    os.makedirs(dumps)
    futs = {
        "dp1": run_world_async(observed_dp, 1, args=(SEED, STEPS, tmp)),
        "dp2": run_world_async(observed_dp, 2, args=(SEED, STEPS, tmp)),
        "desync": run_world_async_ranks(
            desync, 2, (dumps,), [0], env={"HOROVOD_FLIGHT_DIR": dumps}),
    }
    for on in ("1", "0"):
        futs[f"overlap{on}"] = run_world_async(
            overlap_world, 4, args=(SEED,), local_size=2,
            env={"HOROVOD_MESH_SLICES": "2", "HOROVOD_TORUS_ALLREDUCE": "1",
                 "HOROVOD_CROSS_OVERLAP": on})
    out = {k: f.result(timeout=240) for k, f in futs.items()}
    out["dumps"] = dumps
    return out


def run_world_async_ranks(fn, size, args, ranks, env):
    import concurrent.futures

    from torch_port_helpers import run_world
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_world, fn, size, args, env, 120.0, ranks)
    pool.shutdown(wait=False)
    return fut


# --- flight -----------------------------------------------------------

def _flight_script(rec, mod, dtype_of):
    """The same records through one package's recorder (module singleton
    swapped for ``rec``)."""
    rng = np.random.default_rng(SEED)
    mod._recorder, mod.armed = rec, True
    # The step listener (the step profiler's ledger) is left out: these
    # marks are the recorder's alone.
    mod._step_listener = None
    for i in range(12):
        ps = "global" if i % 3 else "set1"
        nbytes = int(rng.integers(1, 1 << 20))
        shapes = [tuple(int(v) for v in rng.integers(1, 9, size=2))
                  for _ in range(2)]
        sig = mod.signature([dtype_of(s, "float32") for s in shapes])
        seq = rec.record_dispatch("allreduce", ps, nbytes, sig, f"t{i}")
        rec.record_complete("allreduce", ps, seq, float(rng.random()))
        if i % 4 == 0:
            rec.record_event("fusion_flush", seq=i, nbytes=nbytes,
                             what=f"n{i}")
            mod.step_marker()
        if i == 7:
            mod.step_marker(100)
            mod.step_marker()          # suppressed after an explicit mark
            rec.record_event("error", op="allgather", name="x",
                             what="boom")
    return [_strip(e) for e in rec.events()], rec.max_seq()


def test_flight_events_and_seqs_equal_jax():
    jr, pr = j_rec.FlightRecorder(64), p_rec.FlightRecorder(64)
    saved = [(j_rec._recorder, j_rec.armed), (p_rec._recorder, p_rec.armed)]
    listeners = (j_rec._step_listener, p_rec._step_listener)
    try:
        je, js = _flight_script(
            jr, j_rec, lambda s, d: jnp.zeros(s, dtype=d))
        pe, ps = _flight_script(
            pr, p_rec, lambda s, d: torch.zeros(s, dtype=getattr(torch, d)))
    finally:
        (j_rec._recorder, j_rec.armed), (p_rec._recorder, p_rec.armed) = \
            saved
        j_rec._step_listener, p_rec._step_listener = listeners
    assert pe == je
    assert ps == js == {"global": 8, "set1": 4}
    # auto, auto, the explicit 100; the auto marks after it are suppressed
    assert [e.get("seq") for e in pe if e["kind"] == "step"] == [1, 2, 100]
    assert pr.summary()["by_kind"] == jr.summary()["by_kind"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32"])
def test_flight_signature_equal_jax(dtype):
    shapes = [(3, 5), (7,), (2, 1, 4)]
    j = j_rec.signature([jnp.zeros(s, dtype=dtype) for s in shapes])
    p = p_rec.signature([torch.zeros(s, dtype=getattr(torch, dtype))
                         for s in shapes])
    assert p == j


def test_analyzers_name_the_same_desync_over_port_dumps(worlds):
    events, metas, marks = p_analyze.load_dir(worlds["dumps"])
    assert len(metas) == 2 and {m["rank"] for m in metas} == {0, 1}
    rep_p = p_analyze.analyze(events, metas, marks)
    jev, jmetas, jmarks = j_analyze.load_dir(worlds["dumps"])
    rep_j = j_analyze.analyze(jev, jmetas, jmarks)
    for rep in (rep_p, rep_j):
        d = rep["desync"]["global"]
        assert d["desynced"] and d["lagging_ranks"] == [1]
        assert d["first_diverging"]["name"] == "skipped_by_rank1"
        assert d["first_diverging"]["rank"] == 0
    assert rep_p["desync"] == rep_j["desync"]
    order = [[r["rank"] for r in v["ranked"]]
             for _, v in sorted(rep_p["stragglers"].items())]
    assert order == [[r["rank"] for r in v["ranked"]]
                     for _, v in sorted(rep_j["stragglers"].items())]
    assert order and all(len(o) == 2 for o in order)
    assert rep_p["steps"] == rep_j["steps"]


# --- goodput ------------------------------------------------------------

def _goodput_script(mod):
    rng = np.random.default_rng(SEED)
    g, s = mod.GoodputLedger(), mod.ServingGoodput()
    now = 10.0
    g.start(now=now)
    snaps = []
    for i in range(30):
        now += float(rng.uniform(0.01, 0.2))
        att = {"host_dispatch": float(rng.uniform(0, 0.01)),
               "collective": float(rng.uniform(0, 0.05)) +
               (0.3 if i == 20 else 0.0),
               "cross_wait": float(rng.uniform(0, 0.002))}
        rec = None if i == 0 else {"attribution": att}
        if i == 5:
            g.note_commit(0.03)
        if i == 12:
            g.on_reset(now=now)
            now += 0.5
            g.note_recovery("failure", 0.5)
        if i == 15:
            g.set_trial(True)
        if i == 17:
            g.set_trial(False)
        if i == 24:
            g.note_wedge(now=now)
            now += 0.25
            g.note_unwedged(now=now)
        g.on_step_boundary(rec, step=i if i % 5 else None, now=now)
        s.record_decode_step(float(rng.uniform(0, 0.05)),
                             int(rng.integers(0, 5)), in_slo=i % 7 != 0)
        snaps.append(g.snapshot(now=now + 0.01))
    return snaps, s.snapshot()


def test_goodput_snapshots_equal_jax():
    js, jserv = _goodput_script(j_gp)
    ps, pserv = _goodput_script(p_gp)
    assert pserv == jserv
    for a, b in zip(ps, js):
        assert a.keys() == b.keys()
        for k in a:
            if k == "categories":
                for c in a[k]:
                    assert abs(a[k][c] - b[k][c]) <= 1e-12, c
            elif isinstance(a[k], float):
                assert abs(a[k] - b[k]) <= 1e-12, k
            else:
                assert a[k] == b[k], k
        assert a["conservation_error"] <= 0.01
    assert ps[-1]["resets"] == 1 and ps[-1]["categories"]["wedge_idle"] > 0


def test_goodput_report_text_equal_jax(tmp_path):
    snaps, _ = _goodput_script(p_gp)
    for run, k in (("good", 29), ("slow", 13)):
        j = p_hist.RunJournal(tmp_path, run_id=run, fingerprint="f")
        j.append("run_start", fingerprint="f", world=2, rank=0, pid=1)
        j.append("goodput", summary=snaps[k])
        if run == "good":
            j.append("run_end", goodput_ratio=snaps[k]["goodput_ratio"])

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    for argv in (["--dir", str(tmp_path), "--run", "good"],
                 ["--dir", str(tmp_path), "--list"],
                 ["--dir", str(tmp_path), "--diff", "good", "slow"]):
        got = run(p_report.main, argv)
        assert got == run(j_report.main, argv)
        assert got[1]
    assert p_hist.read_runs(tmp_path) == j_hist.read_runs(tmp_path)


# --- profile ------------------------------------------------------------

class _Clock:
    """A scripted stand-in for the ledger module's ``time``."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def time(self):
        return self.t + 1e9


def _ledger_script(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    led = mod.StepLedger(history=64)
    led.set_flops_per_step(2.0e9)
    rng = np.random.default_rng(SEED)
    recs = []
    for i in range(12):
        clock.t += float(rng.uniform(0.05, 0.1))
        for _ in range(3):
            led.add_dispatch("allreduce", float(rng.uniform(0, 0.01)),
                             float(rng.uniform(0, 0.001)),
                             int(rng.integers(1, 1 << 16)))
        led.add_fusion_flush(float(rng.uniform(0.01, 0.02)),
                             float(rng.uniform(0, 0.005)),
                             float(rng.uniform(0, 0.003)), "int8", 4096)
        led.add_cross_wait(float(rng.uniform(0, 0.004)))
        led.add_control_plane(0.0)
        rec = led.on_step(i)
        if rec is not None:
            recs.append({k: v for k, v in rec.items()
                         if k not in ("t", "plan", "kv")})
    assert led.on_step(None) is None     # auto marks after explicit ones
    monkeypatch.setattr(mod, "_ledger", led)
    return recs, mod.digest(last=8), led.summary()


def test_step_records_and_digest_equal_jax(monkeypatch):
    jr, jd, jsum = _ledger_script(j_ledger, monkeypatch)
    pr, pd, psum = _ledger_script(p_ledger, monkeypatch)
    assert pr == jr and len(pr) == 11
    assert pd == jd
    assert psum == jsum
    assert all(set(r["attribution"]) == set(j_ledger.CATEGORIES) |
               {"compute"} for r in pr)


def _watchdog_script(mod):
    mod.reset()
    mod._findings.clear()
    walls = [0.1, 0.11, 0.1, 0.09, 0.1, 0.105, 0.1, 0.1, 0.1, 0.6, 0.1]
    for i, w in enumerate(walls):
        mod.observe({"step": i, "rank": 0, "wall_s": w,
                     "attribution": {"host_dispatch": 0.001}})
    rows = {r: {"rank": r, "wall": 0.1, "host": 0.001 + (0.09 if r == 2
                                                         else 0.0001 * r)}
            for r in range(6)}
    mod._name_stragglers(rows, {"step": 16}, 0)
    out = mod.findings()
    mod.reset()
    mod._findings.clear()
    return out


def test_watchdog_findings_equal_jax():
    p = _watchdog_script(p_wd)
    assert p == _watchdog_script(j_wd)
    assert [f["kind"] for f in p] == ["regression", "straggler"]
    assert p[1]["rank"] == 2


def test_roofline_equal_under_equal_peaks():
    peaks = {"bf16_tflops": 989.0, "hbm_gbs": 3350.0, "ici_gbs": 450.0,
             "dcn_gbs": 50.0, "chip": "h100"}
    assert p_roof.mfu(3.2e12, 0.02, peaks) == j_roof.mfu(3.2e12, 0.02, peaks)
    for world, slices in ((8, 2), (4, 1)):
        b = {"ici": 123456789, "dcn": 987654}
        assert p_roof.tier_time_estimate(b, world, slices, peaks) == \
            j_roof.tier_time_estimate(b, world, slices, peaks)
    assert j_roof.chip_peaks("cpu") == p_roof.chip_peaks("cpu")
    assert set(p_roof.PEAKS) == {"h100", "cpu"}
    frac, _ = p_roof.mfu(3.2e12, 0.02, p_roof.chip_peaks("h100"))
    assert 0 < frac < 1


def test_flop_count_sees_the_cpu_step():
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(8, 64, requires_grad=True)
    flops, out = p_roof.flops_of_step(lambda: lin(x).sum().backward())
    # forward 2*8*64*32, backward twice that (input and weight grads)
    assert flops == 3 * 2 * 8 * 64 * 32 and out is None
    assert p_roof.attention_flops(2, 16, 16, 8, causal=True) == \
        3 * 0.5 * 4 * 2 * 16 * 16 * 8


# --- metrics, merge, trace, timeline --------------------------------------

def _metrics_script(m):
    m.REGISTRY.reset()
    m.reset_tier_split()
    rng = np.random.default_rng(SEED)
    for i in range(20):
        op = ("allreduce", "allgather", "broadcast")[i % 3]
        m.record_collective(op, int(rng.integers(0, 1 << 20)),
                            "global" if i % 2 else "set1")
        m.record_collective_latency(op, float(rng.random()) * 1e-3)
        m.record_fusion_flush(int(rng.integers(1, 40)),
                              int(rng.integers(1, 1 << 24)), 1 << 24)
        m.record_wire("fused", "int8", int(rng.integers(1, 1 << 20)),
                      compressed=True,
                      tiers={"ici": 100 + i, "dcn": 7 * i})
        m.record_step(float(rng.random()))
    m.record_collective_error("allgather")
    m.record_boundary("applied")
    m.record_boundary("deferred")
    m.record_elastic_event("reset")
    m.record_elastic_recovery("failure", 1.25)
    m.record_goodput_seconds("productive_compute", 3.5)
    m.record_profiler_event("straggler")
    m.record_stall("warning")
    m.record_serving_step(0.01, 3, 4, tokens=3)
    text = m.REGISTRY.render_text()
    snap = m.REGISTRY.snapshot()
    m.REGISTRY.reset()
    return text, snap


def test_metrics_text_and_merge_equal_jax():
    jt, jsnap = _metrics_script(j_metrics)
    pt, psnap = _metrics_script(p_metrics)
    assert pt == jt
    assert psnap == jsnap
    a = j_merge.add_labels(j_merge.compact(jsnap), slice="0")
    b = j_merge.compact(jsnap)
    want = j_merge.merge_snapshots([a, b, b])
    got = p_merge.merge_snapshots([p_merge.add_labels(p_merge.compact(psnap),
                                                      slice="0"),
                                   p_merge.compact(psnap),
                                   p_merge.compact(psnap)])
    assert got == want
    assert p_merge.render_text(got) == j_merge.render_text(want)


def _shards():
    rng = np.random.default_rng(SEED)
    shards = []
    for rank in range(2):
        traces = []
        for k in range(3):
            t0 = 1000.0 + float(rng.random())
            spans = [{"name": ph, "t0": t0 + j * 0.1,
                      "dur": float(rng.uniform(0.01, 0.09))}
                     for j, ph in enumerate(("queue", "prefill", "decode",
                                             "stream"))]
            spans.append({"name": "requeue", "t0": t0 + 0.05,
                          "ph": "instant"})
            traces.append({"tid": f"t{rank}-r{k}", "rid": k,
                           "kind": "request", "t0": t0, "dur": 0.5,
                           "done": True, "spans": spans})
        shards.append({"rank": rank, "pid": 7, "traces": traces})
    return shards


def test_trace_merge_equal_jax(tmp_path):
    shards = _shards()
    rows = p_tanalyze.merge(shards)
    assert rows == j_tanalyze.merge(shards) and len(rows) == 6
    assert [p_tanalyze.summarize(r) for r in rows] == \
        [j_tanalyze.summarize(r) for r in rows]
    pp, jp = tmp_path / "p.json", tmp_path / "j.json"
    p_tanalyze.write_perfetto(rows, pp)
    j_tanalyze.write_perfetto(rows, jp)
    assert json.loads(pp.read_text()) == json.loads(jp.read_text())


def _timeline_events(tl, path):
    with tl.op_span("grad.0", "ALLREDUCE"):
        pass
    tl.mark_step(3)
    with tl.op_span(None, "BROADCAST"):
        pass
    tl.negotiate("g", "ALLGATHER", 5.0)
    tl.record_counter("collective_ops_total", 7)
    tl.mark_cycle()
    tl.close()
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    return [(e["name"], e["ph"], e["cat"], e["tid"]) for e in ev]


def test_timeline_events_equal_jax(tmp_path):
    jt = _timeline_events(
        j_timeline.Timeline(str(tmp_path / "j.json"), mark_cycles=True,
                            native=False), tmp_path / "j.json")
    pt = _timeline_events(
        p_timeline.Timeline(str(tmp_path / "p.json"), mark_cycles=True),
        tmp_path / "p.json")
    assert pt == jt
    assert pt[0][:2] == ("clock_sync", "M") and len(pt) == 7


# --- the port's planes armed on its own worlds ----------------------------

@pytest.mark.parametrize("size", [1, 2])
def test_armed_dp_run(worlds, size):
    for rank, out in enumerate(worlds[f"dp{size}"]):
        assert out["armed"].keys() == out["plain"].keys()
        for n in out["plain"]:
            assert np.array_equal(out["armed"][n], out["plain"][n]), n
        snap = out["goodput"]
        assert snap["enabled"] and snap["conservation_error"] <= 0.01
        assert snap["steps"] == STEPS
        recs = out["records"]
        assert len(recs) == STEPS
        for r in recs:
            assert set(r["attribution"]) == set(p_ledger.CATEGORIES) | \
                {"compute"}
            assert r["rank"] == rank and r["collectives"] >= 1
        disp = {(e["ps"], e["seq"]) for e in out["events"]
                if e["kind"] == "dispatch"}
        done = {(e["ps"], e["seq"]) for e in out["events"]
                if e["kind"] == "complete"}
        assert disp and disp == done
        seqs = sorted(s for ps, s in disp if ps == "global")
        assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
        spans = [e for e in out["timeline"] if e[2] == "ALLREDUCE"
                 and e[0].startswith("fused_allreduce")]
        assert out["timeline"][0][0] == "clock_sync"
        assert len(spans) == out["buckets"] >= STEPS
        assert sum(1 for e in out["timeline"] if e[2] == "step") == STEPS
        assert 'horovod_fusion_flushes_total' in out["metrics"]


@pytest.mark.parametrize("size", [1, 2])
def test_armed_planes_add_no_sync_read_or_allocation(worlds, size):
    """The hot-path contract (a short lock and a few stores per event),
    counted rather than timed: over an armed run, no plane module called a
    host sync, a device-to-host read or a tensor allocation."""
    for out in worlds[f"dp{size}"]:
        assert out["plane_calls"] == {}
        assert out["buckets"] >= STEPS


def test_cross_overlap_on_and_off_bit_equal(worlds):
    """The knob is read, and the port's stream-ordered buckets give the
    overlap either way: torus buckets reduce bit-equal with it on and
    off."""
    for on, off in zip(worlds["overlap1"], worlds["overlap0"]):
        assert on["knob"] is True and off["knob"] is False
        for a, b in zip(on["got"], off["got"]):
            assert np.array_equal(a, b)
        assert on["strategies"] == off["strategies"]
        assert off["strategies"]["torus"] >= 1

"""The port's device-memory plane against the JAX package's, on the CPU.

The same inputs go through ``dlrover_tpu`` and ``dlrover_tpu_torch`` in
one process, each package's ``device_bytes`` pinned to the same device
view and its clocks faked:

- the ledger (register/release/adjust, watermarks, step marks, top
  buffers), reconciliation (headroom, unattributed bytes, the synthetic
  limit, degraded sweeps) and pressure with hysteresis give equal
  snapshots and journals (timestamps aside), and the ``mem.pressure``
  chaos site forces the breach in both;
- the fleet memory monitor gives equal verdicts, journals, projections
  and ``/memory`` status;
- the KV arithmetic is equal;
- the compile watch gives equal storm journals on the reference's storm
  sequences;
- ``report.py`` renders the same text for the same journal and bundle;
- the owners claim exact bytes: the serving engine's KV buffers, the
  trainer's state, a shm frame (released at close) and a fabric staging
  session (released when it hands the payload off);
- a ``mem.pressure`` drill in a master ends in a bundle holding
  ``memory.json`` that the port's report CLI renders, in a subprocess.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dlrover_tpu import chaos as jax_chaos
from dlrover_tpu.observability import compile_watch as jax_cw
from dlrover_tpu.observability import flight_recorder as jax_fr
from dlrover_tpu.observability import journal as jax_journal
from dlrover_tpu.observability import memory as jax_mem
from dlrover_tpu.observability import registry as jax_registry
from dlrover_tpu.observability import report as jax_report

from dlrover_tpu_torch import chaos as port_chaos
from dlrover_tpu_torch.common.constants import MetricLabel
from dlrover_tpu_torch.observability import compile_watch as port_cw
from dlrover_tpu_torch.observability import flight_recorder as port_fr
from dlrover_tpu_torch.observability import journal as port_journal
from dlrover_tpu_torch.observability import memory as port_mem
from dlrover_tpu_torch.observability import registry as port_registry
from dlrover_tpu_torch.observability import report as port_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": dict(mem=jax_mem, cw=jax_cw, journal=jax_journal,
                registry=jax_registry, fr=jax_fr, report=jax_report,
                chaos=jax_chaos),
    "torch": dict(mem=port_mem, cw=port_cw, journal=port_journal,
                  registry=port_registry, fr=port_fr, report=port_report,
                  chaos=port_chaos),
}

MIB = 1 << 20


@pytest.fixture(autouse=True)
def _reset_injectors():
    yield
    jax_chaos.reset_injector()
    port_chaos.reset_injector()


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _events(journal):
    return [(e["kind"], e["source"], e["data"]) for e in journal.events()]


def _lines(text, prefixes):
    return sorted(ln for ln in text.splitlines() if ln.startswith(prefixes))


# -- the accountant ------------------------------------------------------------


def _ledger_drive(p, acct, clock, set_device):
    """The reference's ledger, reconcile and pressure cases in one run."""
    out = {}
    cats = MetricLabel.MEMORY_CATEGORIES
    with pytest.raises(ValueError):
        acct.register("hbm_misc", "x", 1)
    rng = np.random.default_rng(11)
    for i in range(40):
        clock.t += 0.5
        cat = cats[int(rng.integers(len(cats)))]
        name = f"buf{int(rng.integers(6))}"
        op = int(rng.integers(3))
        if op == 0:
            acct.register(cat, name, int(rng.integers(1, 4096)))
        elif op == 1:
            acct.release(cat, name)
        else:
            acct.adjust(cat, name, int(rng.integers(-64, 4096)))
        if i % 7 == 0:
            acct.step_mark(i)
    out["released"] = acct.release(MetricLabel.MEM_OTHER, "never")
    out["totals"] = (acct.total_bytes(),
                     [acct.bytes_for(c) for c in cats])
    set_device((30_000, 0))
    out["rec_override"] = acct.reconcile()
    set_device(None)
    acct.reconcile()
    acct.reconcile()  # one degraded event per episode
    set_device((0, 0))
    acct.reconcile()
    # hysteresis on a 100 KiB limit: breach, inside the band, re-arm
    acct.register(MetricLabel.MEM_PARAMS, "w", 0)
    base = acct.total_bytes() - acct.bytes_for(MetricLabel.MEM_PARAMS)
    for want in (0.15, 0.15, 0.21, 0.15, 0.30, 0.10):
        acct.register(MetricLabel.MEM_PARAMS, "w",
                      int(102_400 * (1 - want)) - base)
        out.setdefault("pressure", []).append(acct.reconcile())
    out["snapshot"] = acct.snapshot()
    out["wire"] = acct.wire_snapshot()
    out["limit"] = acct.limit_bytes()
    return out


@pytest.mark.parametrize("limit", ["override", "env"])
def test_ledger_reconcile_and_pressure_match(monkeypatch, limit):
    results = {}
    for pkg, p in PKGS.items():
        device = {"view": (0, 0)}
        monkeypatch.setattr(p["mem"], "device_bytes",
                            lambda d=device: d["view"])
        if limit == "env":
            monkeypatch.setenv("DLROVER_TPU_HBM_LIMIT_BYTES", "102400")
        clock = FakeClock()
        journal = p["journal"].EventJournal()
        registry = p["registry"].MetricsRegistry()
        hooked = []
        acct = p["mem"].MemoryAccountant(
            journal=journal, registry=registry, source="worker_0",
            limit_bytes=102_400 if limit == "override" else None,
            pressure_frac=0.2, breach_hook=hooked.append, monotonic=clock)
        out = _ledger_drive(p, acct, clock,
                            lambda v, d=device: d.__setitem__("view", v))
        out["journal"] = _events(journal)
        out["hooked"] = hooked
        out["gauges"] = _lines(registry.render(), ("dlrover_memory",))
        results[pkg] = out
    assert results["torch"] == results["jax"]
    got = results["torch"]
    kinds = [k for k, _, _ in got["journal"]]
    assert kinds.count("memory_degraded") == 1
    # breach, (same episode), inside the band, (same), re-armed, breach
    assert kinds.count("memory_pressure") == 2 and len(got["hooked"]) == 2
    assert got["limit"] == 102_400


def test_mem_pressure_site_forces_the_breach_in_both(monkeypatch):
    results = {}
    for pkg, p in PKGS.items():
        monkeypatch.setattr(p["mem"], "device_bytes", lambda: (0, 0))
        journal = p["journal"].EventJournal()
        acct = p["mem"].MemoryAccountant(
            journal=journal, registry=p["registry"].MetricsRegistry(),
            limit_bytes=1 << 30, source="worker_0",
            monotonic=FakeClock())
        acct.register(MetricLabel.MEM_KV_CACHE, "kv", 1024)
        p["chaos"].configure("mem.pressure:error@times=1", seed=7)
        first = acct.reconcile()
        acct.reconcile()
        results[pkg] = (first, _events(journal))
    assert results["torch"] == results["jax"]
    first, events = results["torch"]
    assert first["headroom_frac"] > 0.9
    assert [(k, d["forced"]) for k, _, d in events] == [
        ("memory_pressure", True)]


# -- the fleet monitor ----------------------------------------------------------


def _wire(headroom_frac, headroom_bytes, kv=0, limit=1000):
    return {"seq": 1, "categories": {MetricLabel.MEM_KV_CACHE: kv},
            "total_bytes": kv, "limit_bytes": limit,
            "headroom_bytes": headroom_bytes,
            "headroom_frac": headroom_frac}


def test_fleet_monitor_matches(monkeypatch):
    results = {}
    for pkg, p in PKGS.items():
        clock = FakeClock()
        journal = p["journal"].EventJournal()
        registry = p["registry"].MetricsRegistry()
        mon = p["mem"].FleetMemoryMonitor(
            event_journal=journal, registry=registry, pressure_frac=0.2,
            stale_s=30.0, monotonic=clock)
        out = []
        mon.observe(0, {"0": _wire(0.5, 500, kv=100)})
        mon.observe(1, {"1": _wire(0.1, 100, kv=300)})
        mon.observe(1, {"1": _wire(0.1, 100, kv=300)})
        mon.observe(0, {"2": _wire(0.05, 50), "bad": _wire(0.9, 9)})
        out.append((mon.fleet_headroom_bytes(), mon.kv_bytes_per_replica(),
                    mon.status()))
        monkeypatch.setattr(p["mem"], "device_bytes", lambda: (0, 0))
        acct = p["mem"].MemoryAccountant(
            registry=p["registry"].MetricsRegistry(), limit_bytes=1000,
            monotonic=clock)
        acct.register(MetricLabel.MEM_KV_CACHE, "kv", 900)
        acct.reconcile()
        mon.observe(3, {"12": acct.wire_snapshot()})
        out.append(mon.status())
        clock.t += 31.0
        out.append((mon.status(), mon.fleet_headroom_bytes(),
                    mon.kv_bytes_per_replica()))
        out.append(_events(journal))
        out.append(_lines(registry.render(), ("dlrover_fleet",)))
        results[pkg] = out
    assert results["torch"] == results["jax"]
    events = results["torch"][3]
    # rank 12 (0.1) is not tighter than rank 2 (0.05): no new verdict
    assert [d["rank"] for _, _, d in events] == [1, 2]
    assert results["torch"][2][0]["stale_ranks"] == [0, 1, 2, 12]


def test_kv_arithmetic_matches():
    config = SimpleNamespace(n_layers=32, n_kv_heads=8, head_dim=128)
    for pkg in PKGS:
        m = PKGS[pkg]["mem"]
        got = [m.kv_bytes_per_slot_theoretical(config, 4096, q)
               for q in (False, True)]
        ceil = [m.max_slots_ceiling(got[0], h)
                for h in (-1, 0, got[0] - 1, 10 * got[0] + 5)]
        if pkg == "jax":
            ref = (got, ceil, m.max_slots_ceiling(0, 1 << 30))
        else:
            assert (got, ceil, m.max_slots_ceiling(0, 1 << 30)) == ref
    assert ref[1] == [0, 0, 0, 10]


# -- the compile watch ----------------------------------------------------------


def _storm_sequences(w, clock):
    """The reference's storm tests, one after another on one watcher."""
    out = []
    out.append([w.note("prefill", batch=8, seq_len=128),
                w.note("prefill", batch=8, seq_len=128),
                w.note("prefill", batch=8, seq_len=256)])
    with w.time("step", batch=4) as t1:
        pass
    with w.time("step", batch=4) as t2:
        pass
    out.append([t1.miss, t2.miss])
    for b in range(4):
        w.note("decode", batch=b)
        clock.t += 1.0
    w.note("decode", batch=99)
    clock.t += 60.0
    for b in range(100, 104):
        w.note("decode", batch=b)
        clock.t += 1.0
    for _ in range(50):
        w.note("decode", batch=1)
    for bucket in (128, 256, 512, 1024):
        w.note("prefill2", batch=8, bucket=bucket)
    for i in range(4):
        w.note("other_fn", weird=i)
    for rows in (8, 7, 5, 4, 3, 2, 1, 6):
        w.note("decode_step", rows=rows, dtype="bf16")
        clock.t += 2.0
    out.append([w.compile_count(f) for f in
                ("prefill", "decode", "decode_step", "nope")])
    out.append(w.compile_count())
    out.append(w.snapshot())
    return out


def test_compile_storms_match():
    results = {}
    for pkg, p in PKGS.items():
        clock = FakeClock()
        journal = p["journal"].EventJournal()
        registry = p["registry"].MetricsRegistry()
        w = p["cw"].CompileWatcher(journal=journal, registry=registry,
                                   storm_threshold=4, window_s=10.0,
                                   monotonic=clock)
        out = _storm_sequences(w, clock)
        out.append(_events(journal))
        out.append(_lines(registry.render(), (
            "dlrover_compile_total", "dlrover_compile_cache",
            "dlrover_compile_distinct", "dlrover_compile_storms")))
        results[pkg] = out
    assert results["torch"] == results["jax"]
    storms = [d for k, _, d in results["torch"][-2]
              if k == "recompile_storm"]
    assert [s["dim"] for s in storms] == ["batch", "batch", "seq_len",
                                          "unknown", "batch"]


# -- the report CLI ---------------------------------------------------------------


def _journal_dict():
    """A journal with two incidents, a rollback and a restore rung."""
    evs = []

    def ev(t, kind, **data):
        evs.append({"seq": len(evs) + 1, "t": t, "kind": kind,
                    "source": "master", "data": data})

    ev(1.0, "rdzv_complete", round=1)
    ev(2.0, "step_resumed", step=0)
    ev(10.0, "fault_detected", node_id=1, status="failed", step=12)
    ev(10.5, "rdzv_start", round=2)
    ev(12.0, "rdzv_complete", round=2)
    ev(12.5, "restore_start")
    ev(14.0, "restore_complete", medium="shm", step=10)
    ev(15.0, "step_resumed", step=11)
    ev(30.0, "fault_detected", node_id=0, status="failed", step=40)
    ev(31.0, "rdzv_start", round=3)
    return {"events": evs, "now_t": 40.0, "dropped": 0}


@pytest.mark.parametrize("source", ["journal", "bundle", "empty"])
def test_report_text_matches_the_reference(tmp_path, monkeypatch, capsys,
                                           source):
    out = {}
    for pkg, p in PKGS.items():
        monkeypatch.setattr(p["mem"], "device_bytes", lambda: (0, 0))
        root = tmp_path / pkg
        root.mkdir()
        if source == "bundle":
            journal = p["journal"].EventJournal()
            registry = p["registry"].MetricsRegistry()
            acct = p["mem"].MemoryAccountant(
                journal=journal, registry=registry, limit_bytes=1 << 30,
                monotonic=FakeClock())
            acct.register(MetricLabel.MEM_KV_CACHE, "kv_pool", 256 * MIB)
            acct.step_mark(1)
            acct.register(MetricLabel.MEM_KV_CACHE, "kv_pool", 768 * MIB)
            acct.register(MetricLabel.MEM_PARAMS, "weights", 100 * MIB)
            acct.register(MetricLabel.MEM_STAGING, "frame", 512 << 10)
            acct.step_mark(2)
            acct.reconcile()
            fr = p["fr"].FlightRecorder(
                "worker_0", out_dir=str(root), journal=journal,
                registry=registry, cooldown_s=0.0,
                memory_snapshot_fn=acct.snapshot)
            path = fr.capture(p["fr"].REASON_MEMORY)
            # both render the same journal: the port's bundle's
            if pkg == "torch":
                with open(os.path.join(path, "journal.json"), "w") as f:
                    json.dump(_journal_dict(), f)
                with open(os.path.join(path, "memory.json")) as f:
                    shared_mem = json.load(f)
        else:
            path = str(root / "journal.json")
            payload = (_journal_dict() if source == "journal"
                       else {"events": [], "now_t": 5.0})
            with open(path, "w") as f:
                json.dump(payload, f)
        out[pkg] = path
    if source == "bundle":
        # the reference renders the port's bundle files
        for name in ("journal.json", "memory.json"):
            with open(os.path.join(out["jax"], name), "w") as f:
                json.dump(_journal_dict() if name == "journal.json"
                          else shared_mem, f)
    texts = {}
    for pkg, p in PKGS.items():
        assert p["report"].main([out[pkg], "--step-time-s", "0.5"]) == 0
        texts[pkg] = capsys.readouterr().out
    assert texts["torch"] == texts["jax"]
    if source == "bundle":
        assert "  kv_cache        768.0MiB  (peak 768.0MiB)" in texts["torch"]
        assert "limit 1.0GiB, headroom 155.5MiB (15.2%)" in texts["torch"]
    elif source == "journal":
        assert "incident report: 2 incident(s), 1 resolved" in texts["torch"]
    else:
        assert "fault-free" in texts["torch"]


# -- the owners ----------------------------------------------------------------


@pytest.fixture
def fresh_accountant(monkeypatch):
    acct = port_mem.MemoryAccountant(
        registry=port_registry.MetricsRegistry(), limit_bytes=1 << 30)
    monkeypatch.setattr(port_mem, "_default_accountant", acct)
    watcher = port_cw.CompileWatcher(
        registry=port_registry.MetricsRegistry())
    monkeypatch.setattr(port_cw, "_default_watcher", watcher)
    return acct, watcher


def _claims(acct, category):
    return {b["name"]: b["bytes"] for b in acct.snapshot()["top_buffers"]
            if b["category"] == category}


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_claims_its_cache_and_notes_shape_keys(fresh_accountant,
                                                      quantize):
    from dlrover_tpu_torch.serving import engine as eng

    acct, watcher = fresh_accountant
    cfg = eng.tiny_config(cache_len=32)
    params = eng.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    e = eng.BatchDecodeEngine(params, cfg, slots=2, cache_len=32,
                              quantize=quantize, device="cpu")
    exact = sum(t.numel() * t.element_size()
                for bufs in (e._k, e._v, e._ks, e._vs) for t in bufs)
    assert _claims(acct, MetricLabel.MEM_KV_CACHE) == {
        f"engine/{id(e):x}/kv": exact}
    r = e.prefill_rows([1, 2, 3], 8)
    e.insert(r, 0)
    e.prefill_rows([4, 5], 8)
    r2 = e.prefill_with_prefix([1, 2, 3, 4], 16, r.payload, 2)
    e.insert(r2, 1)
    for _ in range(3):
        e.step([1, 2], [True, True])
    assert e.compile_count == 5
    assert {fn: watcher.compile_count(fn) for fn in (
        "engine.prefill", "engine.prefill_sfx", "engine.insert",
        "engine.step")} == {"engine.prefill": 1, "engine.prefill_sfx": 1,
                            "engine.insert": 2, "engine.step": 1}


def test_trainer_claims_exact_state_bytes(fresh_accountant):
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer import optim
    from dlrover_tpu_torch.trainer.elastic import (
        ElasticTrainer,
        make_train_state,
    )
    from dlrover_tpu_torch.parallel.mesh import plan_mesh

    acct, watcher = fresh_accountant
    cfg = llama.LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=64, max_seq_len=16,
                            dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = optim.adamw(1e-3)
    state = make_train_state(params, tx)
    trainer = ElasticTrainer(
        lambda p, b: llama.next_token_loss(p, b, cfg), tx,
        global_batch_size=4, micro_batch_per_replica=2, device="cpu")
    trainer.configure_for_world(plan_mesh(1))
    batch = np.random.default_rng(0).integers(0, 64, size=(2, 2, 9))
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    leaves = optim.tree_leaves(state["params"])
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    opt = sum(t.numel() * t.element_size()
              for t in optim.tree_leaves(state["opt_state"])
              if isinstance(t, torch.Tensor))
    snap = acct.snapshot()["categories"]
    assert snap[MetricLabel.MEM_PARAMS] == nbytes
    assert snap[MetricLabel.MEM_OPT_STATE] == opt
    assert snap[MetricLabel.MEM_ACTIVATIONS] == sum(
        4 * t.numel() for t in leaves)
    assert watcher.compile_count("trainer.train_step") == 1
    assert watcher.snapshot()["distinct_signatures"] == {
        "trainer.train_step": 1}


def test_shm_frame_and_fabric_session_claims(fresh_accountant):
    from dlrover_tpu_torch.ckpt.shm_handler import SharedMemoryHandler
    from dlrover_tpu_torch.common import fabric

    acct, _ = fresh_accountant
    h = SharedMemoryHandler(f"dlrtpu_memtest_{os.getpid()}")
    try:
        assert h._ensure(1 << 20)
        size = h._shm.size
        assert _claims(acct, MetricLabel.MEM_STAGING) == {
            f"ckpt_shm/{h.name}": size}
    finally:
        h.unlink()
    assert _claims(acct, MetricLabel.MEM_STAGING) == {}
    session = fabric._FetchSession("k", 3, 4096, 0, [], [])
    assert _claims(acct, MetricLabel.MEM_STAGING) == {"fabric/k/3": 4096}
    abort, _ = session.run({}, 1, 1.0)
    assert _claims(acct, MetricLabel.MEM_STAGING) == {}


# -- the pressure drill in a master, rendered by the report CLI ----------------

DRILL = r'''
import json, os, sys
os.environ["DLROVER_FAULT_SCHEDULE"] = "mem.pressure:error@times=1"
from dlrover_tpu_torch.common.constants import MetricLabel
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.observability.memory import get_accountant
master = LocalJobMaster(job_name="memdrill", node_num=1)
master.prepare()
try:
    acct = get_accountant()
    acct.register(MetricLabel.MEM_KV_CACHE, "kv", 3 << 20)
    acct.step_mark(1)
    acct.reconcile()
    events = json.loads(master.event_journal.to_json())["events"]
    bundles = [b for b in master.flight_recorder.bundles
               if "memory_pressure" in b]
    with open(os.path.join(os.environ["OUT"], "journal.json"), "w") as f:
        f.write(master.event_journal.to_json())
    print(json.dumps({"kinds": [e["kind"] for e in events],
                      "bundles": bundles,
                      "files": sorted(os.listdir(bundles[0]))}))
finally:
    master.stop()
'''


def test_mem_pressure_drill_leaves_a_bundle_the_report_renders(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OUT=str(tmp_path),
               DLROVER_TPU_TRACE_DIR=str(tmp_path / "bundles"),
               DLROVER_TPU_HBM_LIMIT_BYTES=str(1 << 30))
    env.pop("DLROVER_TPU_HTTP_PORT", None)
    r = subprocess.run([sys.executable, "-c", DRILL], capture_output=True,
                       text=True, env=env, timeout=60)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert "memory_pressure" in got["kinds"]
    assert "memory.json" in got["files"]
    rep = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.observability.report",
         got["bundles"][0]], capture_output=True, text=True, env=env,
        timeout=60)
    assert rep.returncode == 0, rep.stderr[-3000:]
    assert "device memory (HBM ledger at capture):" in rep.stdout
    assert "kv_cache" in rep.stdout and "step watermarks" in rep.stdout
    ref = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu.observability.report",
         got["bundles"][0]], capture_output=True, text=True, env=env,
        timeout=60)
    assert ref.returncode == 0 and ref.stdout == rep.stdout

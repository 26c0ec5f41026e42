"""The serving drills: kill–re-route–restore, and the open-loop burst.

The port's copy of ``dlrover_tpu/serving/drill.py``. One process plays
master, router and load generator; decode replicas run as subprocesses
of :class:`LocalReplicaManager` (so the chaos SIGKILL is a real process
death, which the master's connection-drop grace turns into a failed
node). The traffic-driven autoscaler rides the deadline-paced
``JobAutoScaler`` tick and restores the replica count after the kill.

The zero-loss claim: generation is greedy over replica-identical weights
(the same seed in every subprocess, or weights warm-started from a
peer), so a request is idempotent; every request the kill catches in
flight completes by re-route, and ``lost == 0``. Replicas spawned after
the kill drill's fleet is up draw their random weights from another
seed, so only a warm start from the survivor gives the replacement the
survivor's tokens.

Beside the reference's arguments, both drills take the manager's engine
arguments (``config``, ``device``, ``quantize``; the toy backend takes
none). Both run at the reference's 0.2 s heartbeat and grace
(:data:`HEARTBEAT_S`, :data:`GRACE_S`). :data:`LLAMA_DRILL` and
:data:`LLAMA_KILL_TRAFFIC` are their settings for ``LlamaConfig()``
replicas on one card. ``run_serving_drill``'s result
has the reference's keys and, on top of them: ``detect_s`` (kill →
the victim leaves the registry) and ``restore_s`` (kill → the
replacement registers), both on the journal's clock;
``restored_node`` and its ``warm_start`` (``bytes``, ``seconds``, from
its beats) beside the survivor's ``blob_bytes``; ``probe_tokens``, one
fixed prompt's greedy tokens on every live replica after the restore;
``replica_gauges``, every replica's last beat (the victim's included);
and ``false_deaths``, replicas other than the victim the master
declared lost; ``start_order``, each replica's registration and the peer
its warm start took the most bytes from, with both times on the
journal's clock (the goodput window opens at the first registration, so
the order moves serving goodput: ROADMAP C12); and
``node_fault_bundle``, the master's flight-recorder bundle of the kill
(its manifest, whether its journal holds the victim's loss, and its
incidents, which the reference's stitcher opens only for training
faults). Both drills' results add ``replica_gauges``, ``replica_scrapes``
(each live replica's decode steps and kernel launches read over HTTP
from its ``/metrics``, beside its last beat's) and ``journal_dump`` (the
master's journal as ``EventJournal.to_json()`` gives it).
"""

import contextlib
import json
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

from dlrover_tpu_torch.chaos import configure, get_injector, reset_injector
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RPCClient
from dlrover_tpu_torch.master.auto_scaler import JobAutoScaler
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.master.resource import ResourcePlan
from dlrover_tpu_torch.observability.journal import (
    JournalEvent,
    Phase,
    attribute_phases,
)
from dlrover_tpu_torch.observability.slo import SLOPlane
from dlrover_tpu_torch.serving.autoscaler import (
    ServingOptimizer,
    ServingSignals,
)
from dlrover_tpu_torch.serving.replica import (
    SERVE_REPLICA_SITE,
    WEIGHTS_KEY,
    LocalReplicaManager,
)
from dlrover_tpu_torch.serving.router import RequestRouter
from dlrover_tpu_torch.serving.traffic import (
    OpenLoopGenerator,
    TrafficProfile,
)


# the reference drill's liveness intervals: a replica beats every
# HEARTBEAT_S, and one whose connection dropped is failed after GRACE_S
HEARTBEAT_S = 0.2
GRACE_S = 0.2

# Both drills with LlamaConfig() replicas on one card: a 2048-row int8
# cache in 8 slots, buckets that hold the prompts, and ten minutes for a
# replica to load its 7B random-weight model and register.
LLAMA_DRILL = dict(backend="torch", config="llama", quantize=True, slots=8,
                   cache_len=2048, buckets=(256, 512, 1024),
                   start_timeout_s=600.0)
# The kill drill's traffic at that width: 48 requests from 8 clients over
# the prompt lengths the buckets hold, and a restore long enough for the
# replacement's start and its 12 GB warm start from the survivor.
LLAMA_KILL_TRAFFIC = dict(num_requests=48, concurrency=8,
                          prompt_lens=(64, 200, 500, 1000), max_new_tokens=32,
                          request_timeout_s=300.0, restore_timeout_s=600.0)


class _NoTrainingPlan:
    """A serving-only drill: the training side of the tick plans nothing."""

    def plan(self, stats) -> ResourcePlan:
        del stats
        return ResourcePlan()


def _engine_kwargs(backend, config, device, quantize) -> Dict:
    """The manager's engine arguments; the toy backend takes none."""
    if backend == "toy":
        return {}
    return {"config": config, "device": device, "quantize": quantize}


@contextlib.contextmanager
def _drill_plane(job_name: str, node_num: int, request_timeout_s: float,
                 kill_schedule: Optional[str] = None, seed: int = 0,
                 **manager_kw):
    """A drill's serving plane: the liveness intervals set on the
    process's context, the kill's injector (unless one is configured:
    before the master, whose reporter journals its faults), a master, the
    replica manager and a journaling router. All of it is torn down, and
    the context put back, on exit."""
    ctx = get_context()
    saved = (ctx.heartbeat_interval_s, ctx.conn_drop_grace_s)
    ctx.set("heartbeat_interval_s", HEARTBEAT_S)
    ctx.set("conn_drop_grace_s", GRACE_S)
    own_injector = kill_schedule is not None and get_injector() is None
    if own_injector:
        configure(kill_schedule, seed=seed)
    master = manager = None
    try:
        master = LocalJobMaster(job_name=job_name, node_num=node_num,
                                min_nodes=1)
        master.prepare()
        manager = LocalReplicaManager(
            master.addr, live_fn=master.serve_registry.live,
            heartbeat_interval_s=HEARTBEAT_S, seed=seed,
            **manager_kw)
        router = RequestRouter(
            replicas_fn=master.serve_registry.live,
            journal_fn=lambda kind, **d: master.event_journal.record(
                kind, source="router", **d),
            request_timeout_s=request_timeout_s)
        yield master, manager, router
    finally:
        if manager is not None:
            manager.stop_all()
        if master is not None:
            master.stop()
        ctx.set("heartbeat_interval_s", saved[0])
        ctx.set("conn_drop_grace_s", saved[1])
        if own_injector:
            reset_injector()


def run_traffic_drill(
    replicas: int = 1,
    max_replicas: int = 2,
    backend: str = "toy",
    profile: Optional[TrafficProfile] = None,
    prefix_cache: bool = False,
    slots: int = 2,
    buckets: Sequence[int] = (16, 32, 48),
    cache_len: int = 64,
    step_delay_s: float = 0.01,
    autoscale_interval_s: float = 0.2,
    queue_hi: int = 3,
    grow_cooldown_s: float = 0.3,
    ttft_slo_s: Optional[float] = None,
    request_timeout_s: float = 30.0,
    seed: int = 0,
    config: str = "tiny",
    device: Optional[str] = None,
    quantize: bool = False,
    start_timeout_s: float = 60.0,
) -> Dict:
    """The open-loop drill: a seeded bursty, ramping schedule that does
    not slow down when the plane saturates, so the burst piles a queue
    for the autoscaler to react to. Returns the generator's digest and
    the journal's scale decisions and SLO alerts."""
    if profile is None:
        profile = TrafficProfile(
            rps=30.0, duration_s=4.0, arrival="bursty", burst_factor=4.0,
            diurnal="ramp", length_mix=((0.7, 10, 16), (0.3, 16, 28)),
            shared_prefix_frac=0.6, prefix_len=8, max_new_lo=4,
            max_new_hi=8, seed=seed)
    with _drill_plane(
            "serve-traffic-drill", max_replicas, request_timeout_s,
            seed=seed,
            backend=backend, slots=slots, buckets=buckets,
            max_new_cap=profile.max_new_hi, cache_len=cache_len,
            step_delay_s=step_delay_s if backend == "toy" else 0.0,
            prefix_cache=prefix_cache,
            **_engine_kwargs(backend, config, device, quantize)
    ) as (master, manager, router):
        journal = master.event_journal
        # the SLO plane rides the same tick: it diffs the router's TTFT
        # histogram, journals breaches, and feeds the fast burn into the
        # signals as a leading trigger
        slo_plane = SLOPlane(journal_fn=lambda kind, **d: journal.record(
            kind, source="slo", **d))
        t_start = [0.0]

        def signals() -> ServingSignals:
            t = time.monotonic() - t_start[0] if t_start[0] else 0.0
            slo_plane.tick()
            return ServingSignals(
                live_replicas=len(master.serve_registry.live()),
                target_replicas=manager.target,
                queue_depth=router.inflight(),
                inflight=router.inflight(),
                ttft_p99_s=router.ttft_p99(),
                tokens_per_s=router.tokens_per_s(),
                offered_rps=gen.offered_rps(min(t, profile.duration_s)),
                slo_burn_rate=slo_plane.burn_rate())

        autoscaler = JobAutoScaler(
            master.job_manager, master.perf_monitor,
            optimizer=_NoTrainingPlan(), interval_s=autoscale_interval_s,
            serving_optimizer=ServingOptimizer(
                min_replicas=replicas, max_replicas=max_replicas,
                queue_hi=queue_hi, grow_cooldown_s=grow_cooldown_s,
                ttft_slo_s=ttft_slo_s, shrink_cooldown_s=3600.0),
            serving_signals=signals, serve_scaler=manager,
            event_journal=journal)
        gen = OpenLoopGenerator(
            lambda prompt, max_new: router.submit(
                prompt, max_new, deadline_s=request_timeout_s),
            profile)
        try:
            manager.scale_to(replicas, reason="traffic drill start")
            if not manager.wait_live(replicas, timeout_s=start_timeout_s):
                raise RuntimeError("replicas failed to register")
            autoscaler.start()
            t_start[0] = time.monotonic()
            stats = gen.run()
            slo_plane.tick()  # the last snapshot, after the last answer
        finally:
            autoscaler.stop()
        # one more beat from each replica, so its gauges count the run
        _wait_beats(master.servicer,
                    [r["node_id"] for r in master.serve_registry.live()],
                    time.monotonic(), 10 * HEARTBEAT_S + 5.0)
        kinds: Dict[str, int] = {}
        alert_ts: List[float] = []
        grow_ts: List[float] = []
        for e in journal.events():
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            if e["kind"] == JournalEvent.SLO_BURN_ALERT:
                alert_ts.append(e["t"])
            if (e["kind"] == JournalEvent.SERVE_SCALE
                    and "grow" in e.get("data", {}).get("reason", "")):
                grow_ts.append(e["t"])
        stats.update({
            "backend": backend,
            "replicas_start": replicas,
            "live_replicas_end": len(master.serve_registry.live()),
            "grow_events": len(grow_ts),
            "lost": router.lost,
            "slo_alerts": slo_plane.alerts,
            "first_alert_t": alert_ts[0] if alert_ts else None,
            "first_grow_t": grow_ts[0] if grow_ts else None,
            # positive: the burn alert led the reactive grow
            "slo_lead_s": (round(grow_ts[0] - alert_ts[0], 3)
                           if alert_ts and grow_ts else None),
            "journal": kinds,
            "replica_gauges": _replica_gauges(master),
            "replica_scrapes": _scrape_replicas(master, manager),
            "journal_dump": json.loads(journal.to_json()),
        })
        return stats


def _probe_prompt(length: int) -> List[int]:
    return [1 + ((j * 5 + 3) % 29) for j in range(length)]


def _wait_beats(servicer, node_ids, after: float, timeout_s: float) -> None:
    """Wait until each node has beaten after ``after`` (monotonic), so its
    gauges cover what came before."""
    pacer = threading.Event()  # pacing only, never set
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        beats = [servicer.last_beat(n) for n in node_ids]
        if all(b is not None and b["t"] > after for b in beats):
            return
        pacer.wait(0.05)


def run_serving_drill(
    replicas: int = 2,
    backend: str = "toy",
    num_requests: int = 24,
    concurrency: int = 4,
    kill_mid_traffic: bool = True,
    prompt_lens: Sequence[int] = (3, 5, 7, 10, 12, 14),
    max_new_tokens: int = 6,
    buckets: Sequence[int] = (8, 16),
    slots: int = 4,
    cache_len: int = 48,
    autoscale_interval_s: float = 0.3,
    request_timeout_s: float = 60.0,
    kill_after_completed: Optional[int] = None,
    restore_timeout_s: float = 30.0,
    step_delay_s: Optional[float] = None,
    seed: int = 0,
    config: str = "tiny",
    device: Optional[str] = None,
    quantize: bool = False,
    start_timeout_s: float = 60.0,
) -> Dict:
    """Run the kill drill; returns the metrics and assertion dict."""
    with _drill_plane(
            "serve-drill", replicas, request_timeout_s,
            # the injector decides the kill (and the master journals it);
            # SIGKILL is only the mechanism
            kill_schedule=(f"{SERVE_REPLICA_SITE}:error@nth=1"
                           if kill_mid_traffic else None),
            seed=seed, backend=backend, slots=slots, buckets=buckets,
            max_new_cap=max_new_tokens, cache_len=cache_len,
            # the toy engine decodes in microseconds: pace its steps so
            # the kill lands mid-traffic; a model needs no pacing
            step_delay_s=((0.01 if backend == "toy" else 0.0)
                          if step_delay_s is None else step_delay_s),
            **_engine_kwargs(backend, config, device, quantize)
    ) as (master, manager, router):
        journal = master.event_journal

        def signals() -> ServingSignals:
            return ServingSignals(
                live_replicas=len(master.serve_registry.live()),
                target_replicas=manager.target,
                queue_depth=router.inflight(),
                inflight=router.inflight(),
                ttft_p99_s=router.ttft_p99(),
                tokens_per_s=router.tokens_per_s())

        autoscaler = JobAutoScaler(
            master.job_manager, master.perf_monitor,
            optimizer=_NoTrainingPlan(), interval_s=autoscale_interval_s,
            serving_optimizer=ServingOptimizer(
                min_replicas=1, max_replicas=replicas,
                # the drill's idle moments must not shrink the fleet
                shrink_cooldown_s=3600.0),
            serving_signals=signals, serve_scaler=manager,
            event_journal=journal)
        result: Dict = {"requests": num_requests, "killed_node": None,
                        "backend": backend, "replicas": replicas}
        responses: List = []
        res_lock = threading.Lock()
        next_idx = [0]
        done_evt = threading.Event()
        kill_t: List[float] = []
        try:
            manager.scale_to(replicas, reason="drill start")
            if not manager.wait_live(replicas, timeout_s=start_timeout_s):
                raise RuntimeError(
                    f"replicas failed to register: "
                    f"{len(master.serve_registry.live())}/{replicas} live")
            # the replacement's own random weights differ from the
            # survivor's: the probe tells a warm start from a cold one
            manager.seed = seed + 1
            autoscaler.start()

            def _load_worker() -> None:
                while True:
                    with res_lock:
                        i = next_idx[0]
                        next_idx[0] += 1
                    if i >= num_requests:
                        return
                    plen = prompt_lens[i % len(prompt_lens)]
                    prompt = [1 + ((i * 7 + j * 3) % 23)
                              for j in range(plen)]
                    resp = router.submit(prompt, max_new_tokens,
                                         request_id=f"req-{i:04d}",
                                         deadline_s=request_timeout_s)
                    with res_lock:
                        responses.append(resp)

            def _kill_controller() -> None:
                threshold = (max(1, num_requests // 3)
                             if kill_after_completed is None
                             else kill_after_completed)
                while not done_evt.wait(0.02):
                    if router.completed >= threshold:
                        break
                if done_evt.is_set():
                    return
                inj = get_injector()
                try:
                    if inj is not None:
                        inj.fire(SERVE_REPLICA_SITE, phase="drill_kill")
                except (ConnectionError, RuntimeError):
                    # the injected fault is the kill decision (journaled as
                    # fault_injected by the master's reporter)
                    logger.info("chaos fired on %s: SIGKILLing a replica",
                                SERVE_REPLICA_SITE)
                kill_t.append(journal.now())
                result["killed_node"] = manager.kill_one()

            t0 = time.monotonic()
            workers = [threading.Thread(target=_load_worker,
                                        name=f"serve-load-{i}", daemon=True)
                       for i in range(concurrency)]
            killer = None
            if kill_mid_traffic:
                killer = threading.Thread(target=_kill_controller,
                                          name="serve-chaos", daemon=True)
                killer.start()
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=request_timeout_s * num_requests)
            done_evt.set()
            if killer is not None:
                killer.join(timeout=30.0)
            elapsed = time.monotonic() - t0

            # the master must first detect the kill (the victim leaves the
            # registry) before the autoscaler can see live < target: waiting
            # for live >= N alone would accept the membership still naming
            # the dead replica
            pacer = threading.Event()  # pacing only, never set
            victim = result["killed_node"]
            detected = victim is None
            if victim is not None:
                deadline = time.monotonic() + restore_timeout_s
                while time.monotonic() < deadline:
                    if all(r["node_id"] != victim
                           for r in master.serve_registry.live()):
                        detected = True
                        break
                    pacer.wait(0.05)
            result["kill_detected"] = detected
            restored = detected and manager.wait_live(
                replicas, timeout_s=restore_timeout_s)
            ok = [r for r in responses if r.success]
            ttfts = sorted(r.ttft_s for r in ok)
            # the goodput window ends at the restore, as the reference's
            # does: the probe below is not serving traffic
            now_t = journal.now()
            events = journal.events()
            kinds: Dict[str, int] = {}
            for e in events:
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            result.update(_after_restore(
                master, victim, kill_t, restored, prompt_lens,
                max_new_tokens, request_timeout_s))
            serve_t0 = min((e["t"] for e in events
                            if e["kind"] == JournalEvent.SERVE_REPLICA_UP),
                           default=0.0)
            phases = attribute_phases(events, now_t, start_t=serve_t0)
            window = max(1e-6, now_t - serve_t0)
            total_tokens = sum(len(r.tokens) for r in ok)
            result.update({
                "completed": len(ok),
                "lost": router.lost,
                "failed_responses": len(responses) - len(ok),
                "rerouted": router.rerouted,
                "replicas_restored": restored,
                "live_replicas_end": len(master.serve_registry.live()),
                "elapsed_s": round(elapsed, 3),
                "tokens_total": total_tokens,
                "tokens_per_s": round(total_tokens / max(1e-6, elapsed), 2),
                "ttft_p50_s": (round(ttfts[len(ttfts) // 2], 4)
                               if ttfts else 0.0),
                "ttft_p99_s": round(
                    ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 4
                ) if ttfts else 0.0,
                "serving_goodput": round(phases[Phase.SERVING] / window, 4),
                "journal": kinds,
                "start_order": _start_order(master),
                "node_fault_bundle": _node_fault_bundle(master, victim),
                "replica_scrapes": _scrape_replicas(master, manager),
                "journal_dump": json.loads(journal.to_json()),
            })
            return result
        finally:
            autoscaler.stop()


def _after_restore(master, victim, kill_t, restored, prompt_lens,
                   max_new_tokens, request_timeout_s) -> Dict:
    """The port's additions to the result: kill → detect and kill →
    restore on the journal's clock, the replacement's warm start beside
    the survivor's blob, one probe prompt's tokens on every live
    replica, every replica's last beat, and false deaths."""
    events = master.event_journal.events()
    servicer = master.servicer
    out: Dict = {"detect_s": None, "restore_s": None, "restored_node": None,
                 "warm_start": None, "blob_bytes": None, "probe_tokens": {}}
    lost = [e for e in events if e["kind"] == JournalEvent.SERVE_REPLICA_LOST]
    out["false_deaths"] = sorted(e["data"]["node_id"] for e in lost
                                 if e["data"]["node_id"] != victim)
    victim_lost = next((e for e in lost if e["data"]["node_id"] == victim),
                       None)
    if kill_t and victim_lost is not None:
        out["detect_s"] = victim_lost["t"] - kill_t[0]
        up = next((e for e in events
                   if e["kind"] == JournalEvent.SERVE_REPLICA_UP
                   and e["t"] >= victim_lost["t"]), None)
        if up is not None:
            out["restore_s"] = up["t"] - kill_t[0]
            out["restored_node"] = up["data"]["node_id"]
    live = master.serve_registry.live()
    if restored:
        prompt = _probe_prompt(max(prompt_lens))
        for r in sorted(live, key=lambda r: r["node_id"]):
            resp = RPCClient(r["addr"], timeout_s=request_timeout_s,
                             retries=1).call(
                "serve_generate", comm.ServeGenerateRequest(
                    request_id=f"probe-{r['node_id']}", prompt=prompt,
                    max_new_tokens=max_new_tokens))
            out["probe_tokens"][r["node_id"]] = (
                list(resp.tokens) if resp.success else None)
        # one more beat from each, so its gauges count the probe
        _wait_beats(servicer, [r["node_id"] for r in live],
                    time.monotonic(), 10 * HEARTBEAT_S + 5.0)
    survivor = next((r for r in live if r["node_id"] != out["restored_node"]),
                    None)
    restored_beat = (servicer.last_beat(out["restored_node"])
                     if out["restored_node"] is not None else None)
    gauges = (restored_beat or {}).get("gauges", {})
    if "serve_weight_load_bytes" in gauges:
        out["warm_start"] = {"bytes": gauges["serve_weight_load_bytes"],
                             "seconds": gauges["serve_weight_load_s"]}
        if survivor is not None:
            desc = RPCClient(survivor["addr"], timeout_s=request_timeout_s,
                             retries=1).call(
                "fabric_describe",
                comm.FabricDescribeRequest(key=WEIGHTS_KEY, step=-1))
            out["blob_bytes"] = desc.total_bytes if desc.found else None
    out["replica_gauges"] = _replica_gauges(master)
    return out


def _replica_gauges(master) -> Dict[int, Dict]:
    """The last beat's gauges of every replica that ever registered."""
    seen = {e["data"]["node_id"] for e in master.event_journal.events()
            if e["kind"] == JournalEvent.SERVE_REPLICA_UP}
    return {nid: dict((master.servicer.last_beat(nid) or {})
                      .get("gauges", {}))
            for nid in sorted(seen)}


# a scrape waits this long for a replica's answer, and tries this often:
# a replica exporting its weights holds the GIL in long copies
SCRAPE_TIMEOUT_S = 10.0
SCRAPE_ATTEMPTS = 3


def _scrape_gauge(text: str, name: str) -> Optional[float]:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def _scrape_replicas(master, manager) -> Dict[int, Dict]:
    """Each live replica's decode steps and kernel launches, read from its
    ``/metrics`` over HTTP (the port its beat names, else the one the
    manager picked), with the same two numbers from its last beat."""
    out: Dict[int, Dict] = {}
    ports = getattr(manager, "http_ports", {})
    for r in master.serve_registry.live():
        nid = r["node_id"]
        beat = (master.servicer.last_beat(nid) or {}).get("gauges", {})
        port = int(beat.get("serve_http_port", 0)) or ports.get(nid)
        row: Dict = {"port": port or None, "error": None,
                     "beat_steps": beat.get("serve_decode_steps"),
                     "beat_launches": beat.get("serve_decode_kernel_launches")}
        if not port:
            row["error"] = "no http port"
            out[nid] = row
            continue
        host = r["addr"].rsplit(":", 1)[0]
        for attempt in range(SCRAPE_ATTEMPTS):
            try:
                with urllib.request.urlopen(
                        f"http://{host}:{port}/metrics",
                        timeout=SCRAPE_TIMEOUT_S) as resp:
                    text = resp.read().decode()
                row["steps"] = _scrape_gauge(
                    text, "dlrover_serving_decode_steps")
                row["launches"] = _scrape_gauge(
                    text, "dlrover_serving_decode_kernel_launches")
                row["error"] = None
                break
            except OSError as e:
                row["error"] = repr(e)
                time.sleep(0.5 * (attempt + 1))
        out[nid] = row
    return out


def _start_order(master) -> List[Dict]:
    """Replicas in their order of registration: each one's registration
    and warm-start end (the master's clock), the warm start's seconds
    and the node it took the most bytes from."""
    events = master.event_journal.events()
    ups = [e for e in events if e["kind"] == JournalEvent.SERVE_REPLICA_UP]
    fetched = {e["source"]: e for e in events
               if e["kind"] == JournalEvent.FABRIC_SESSION_COMPLETE}
    order = []
    for e in ups:
        nid = e["data"]["node_id"]
        beat = (master.servicer.last_beat(nid) or {}).get("gauges", {})
        warm = fetched.get(f"agent_{nid}")
        src = beat.get("serve_weight_load_from")
        order.append({
            "node_id": nid, "registered_t": e["t"],
            "warm_start_from": int(src) if src is not None else None,
            "warm_start_end_t": warm["t"] if warm else None,
            "warm_start_s": (warm["data"].get("duration_s")
                             if warm else None)})
    return order


def _node_fault_bundle(master, victim) -> Optional[Dict]:
    """The master's node_fault bundle of the victim: its manifest, whether
    its journal holds the victim's loss, and its incidents."""
    for path in master.flight_recorder.bundles:
        if "node_fault" not in os.path.basename(path):
            continue
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest.get("node_id") != victim:
                continue
            with open(os.path.join(path, "journal.json")) as f:
                journal = json.load(f)
            with open(os.path.join(path, "incidents.json")) as f:
                incidents = json.load(f)
        except (OSError, ValueError):
            continue
        return {
            "path": path, "manifest": manifest,
            "victim_lost": any(
                e["kind"] == JournalEvent.SERVE_REPLICA_LOST
                and e["data"].get("node_id") == victim
                for e in journal.get("events", [])),
            "incidents": incidents["incidents"],
        }
    return None

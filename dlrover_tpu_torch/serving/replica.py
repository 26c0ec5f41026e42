"""The SERVE node: a decode replica process, and its local scaler.

The port's copy of ``dlrover_tpu/serving/replica.py``. A replica registers
with a master (``serve_register``), heartbeats, and serves
``serve_generate`` / ``serve_drain`` / ``serve_ping`` on its own RPC
server, in front of a :class:`ContinuousBatcher` over its engine. Method
names and messages are the reference's, so the JAX package's master and
router drive a port replica, and the reverse. Death needs no
cooperation: a SIGKILL closes the heartbeat connection, the master's
grace recheck fails the node, and the serve registry drops it while the
router re-routes.

Weights ride the fabric (``common/fabric.py``): a replica whose engine
holds real params mounts a ``weights`` provider on its RPC server, and a
new replica warm-starts by striping the exported params from every live
peer at once (:func:`load_weights_from_peers`), in the JAX package's blob
format, so a port replica warm-starts from a JAX one and the reverse.

Each beat carries the replica's gauges: queue depth, active slots, the
prefix cache's hits, the warm start's seconds and bytes, and (port
additions) ``serve_decode_steps`` with ``serve_decode_kernel_launches``,
both taken together after each decode step, so a parent sees the decode
kernel run inside subprocess replicas, the node the warm start took the
most bytes from (``serve_weight_load_from``) and the replica's HTTP port
(``serve_http_port``).

Each replica has its own observability plane, as the reference's does:
an :class:`EventJournal` (request, prefix-cache and fabric events), a
:class:`TailAttributor` fed by every completion, a
:class:`FlightRecorder` whose bundles carry the worst requests'
waterfalls, and an :class:`HTTPTransportServer` (``--http-port``, 0: a
free port) serving ``GET /metrics``, ``/events`` and ``/debug/bundle``.
``/metrics`` also reads the decode steps and kernel launches of the beat
(``dlrover_serving_decode_steps``, ``dlrover_serving_decode_kernel_launches``;
port additions). ``serve_generate`` runs under a ``serve.generate`` span
(joining the router's ``serve.route`` through the frame's ``tc``) and
answers with the request's ``trace_id``; a drain is a ``serve.drain``
span. The warm start's fabric session journals into the replica's
journal and is reported to the master's (``fabric_session_complete`` on
the master's clock).

The chaos site ``serve.replica`` fires in the heartbeat loop: an injected
error crashes the replica with no drain and no deregister.

:class:`LocalReplicaManager` is the local serve scaler: replicas as
subprocesses of this host (a chaos SIGKILL is a real process death),
``scale_to`` its verb (grow spawns, shrink drains). It is the
``serve_scaler`` the ``JobAutoScaler`` tick executes serving plans
through.

Entry point::

    python -m dlrover_tpu_torch.serving.replica --master HOST:PORT \\
        --node-id N [--backend toy|torch] [--config tiny|llama] \\
        [--device cuda|cpu] ...

Besides the reference's flags, ``--backend torch`` builds a model
engine on ``--device`` (default ``cuda``; the toy backend, the
reference's default, takes no device and says it serves no model): with
``--config tiny`` the small f32 model of ``build_tiny_engine``, with
``--config llama`` ``LlamaConfig()`` in bf16 (random weights from
``--seed`` until a peer's arrive).
"""

import argparse
import collections
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common import comm, fabric
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    ConfigKey,
    SpanName,
    env_flag,
)
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.http_server import HTTPTransportServer
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RPCClient, RPCServer, find_free_port
from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.flight_recorder import FlightRecorder
from dlrover_tpu_torch.observability.journal import EventJournal
from dlrover_tpu_torch.observability.registry import get_registry
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.serving.batcher import BatcherClosed, ContinuousBatcher
from dlrover_tpu_torch.serving.engine import (
    BatchDecodeEngine,
    ToyEngine,
    export_params,
    import_params,
    tiny_config,
)
from dlrover_tpu_torch.serving.prefix_cache import maybe_wrap_prefix_cache
from dlrover_tpu_torch.serving.tail import TailAttributor

SERVE_REPLICA_SITE = ChaosSite.SERVE_REPLICA

# fabric key a replica publishes its exported params under
WEIGHTS_KEY = "weights/current"
# the reference's default heartbeat interval (its config context)
HEARTBEAT_INTERVAL_S = 15.0
# a full-width bf16 7B blob is 12 GB: its first describe exports it and
# computes its content CRC
WARM_START_TIMEOUT_S = 600.0


def _same_shapes(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(_same_shapes(a[k], b[k]) for k in a))
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def load_weights_from_peers(engine, peer_addrs, reporter=None,
                            timeout_s: float = WARM_START_TIMEOUT_S
                            ) -> Optional[Dict]:
    """Warm-start ``engine`` from live peers: one striped fabric session
    over every peer serving :data:`WEIGHTS_KEY` (``reporter(kind, data)``
    takes its journal events). Returns the session's stats (``bytes``,
    ``seconds``, ``sources``, and ``by_source``: the bytes each peer
    address served), or None with the engine untouched when no peer
    serves weights, the session aborts or the peer's params do not fit
    the engine: growth never fails on this."""
    if not hasattr(engine, "set_params") or not peer_addrs:
        return None
    t0 = time.monotonic()
    try:
        _step, blob, stats = fabric.fetch(
            [fabric.FabricSource(addr=a) for a in peer_addrs], WEIGHTS_KEY,
            timeout_s=timeout_s, reporter=reporter)
    except fabric.FabricAbort as e:
        logger.info("peer weight load aborted (%s); keeping seed weights",
                    e.reason)
        return None
    params = import_params(blob, device=engine.device)
    del blob
    if not _same_shapes(params, engine.params):
        logger.warning("peer weights do not fit this engine; keeping seed "
                       "weights")
        return None
    engine.set_params(params)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    duration = time.monotonic() - t0
    get_registry().histogram(
        "dlrover_serving_weight_load_seconds",
        "Wall-clock time to warm-start a replica's weights from peers",
    ).observe(duration)
    logger.info("warm-started weights from %s peer(s): %s bytes in %.3fs",
                stats["sources"], stats["bytes"], duration)
    return {"bytes": stats["bytes"], "seconds": duration,
            "sources": stats["sources"],
            "by_source": dict(stats["bytes_by_source"])}


class DecodeReplica:
    def __init__(self, master_addr: str, node_id: int, engine,
                 buckets=(8, 16), max_new_cap: int = 64,
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_interval_s: Optional[float] = None,
                 request_timeout_s: float = 60.0,
                 on_crash: Optional[Callable[[], None]] = None,
                 http_port: int = 0, registry=None):
        self.node_id = node_id
        self.engine = engine
        source = f"replica_{node_id}"
        # (decode steps, decode-kernel launches), taken together after
        # each step
        self._decode_counts = (0, 0)
        # the replica's own observability plane; ``registry`` (default:
        # the process's) is what /metrics renders
        self.registry = registry if registry is not None else get_registry()
        self.journal = EventJournal()

        def journal_fn(kind, **data):
            self.journal.record(kind, source=source, **data)

        self.tail = TailAttributor(journal_fn=journal_fn,
                                   registry=self.registry)
        self._batcher = ContinuousBatcher(
            engine, buckets=buckets, max_new_cap=max_new_cap,
            journal_fn=journal_fn, registry=self.registry,
            on_complete=self.tail.observe, source=source,
            on_step=self._on_step)
        self.registry.gauge(
            "dlrover_serving_decode_steps",
            "decode steps this replica ran (its beat's serve_decode_steps)",
        ).set_function(lambda: self._decode_counts[0])
        self.registry.gauge(
            "dlrover_serving_decode_kernel_launches",
            "decode-kernel launches of those steps (its beat's "
            "serve_decode_kernel_launches)",
        ).set_function(lambda: self._decode_counts[1])
        self.recorder = FlightRecorder(
            source=source, journal=self.journal, registry=self.registry,
            worst_traces_fn=self.tail.worst_requests)
        try:
            self._http_server = HTTPTransportServer(host=host,
                                                    port=http_port)
        except OSError as e:
            # the port a parent picked was taken meanwhile: any free one
            # (the beat's serve_http_port says which)
            logger.warning("replica %s: http port %s unavailable (%r); "
                           "binding a free one", node_id, http_port, e)
            self._http_server = HTTPTransportServer(host=host, port=0)
        self._http_server.add_get_route(
            "/metrics",
            lambda: ("text/plain; version=0.0.4", self.registry.render()))
        self._http_server.add_get_route(
            "/events", lambda: ("application/json", self.journal.to_json()))
        self._http_server.add_get_route("/debug/bundle",
                                        self.recorder.http_handler())
        self._server = RPCServer(host=host, port=port)
        self._server.register_object(self)
        # an engine with real params serves them to warm-starting peers
        self._weights_lock = threading.Lock()
        self._weights_blob = None
        if hasattr(engine, "set_params"):
            self._fabric = fabric.FabricServer(self._server)
            self._fabric.register_provider("weights", self._provide_weights)
        self._host = host
        self._client = MasterClient(master_addr, node_id=node_id)
        self._hb_interval_s = (HEARTBEAT_INTERVAL_S
                               if heartbeat_interval_s is None
                               else heartbeat_interval_s)
        self._request_timeout_s = request_timeout_s
        self._stop_evt = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._on_crash = on_crash
        self.crashed = False
        # the stats of this replica's warm start from its peers, if any
        self.warm_start: Optional[Dict] = None

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._server.port}"

    @property
    def http_addr(self) -> str:
        """``GET /metrics``, ``/events``, ``/debug/bundle``, ``/healthz``."""
        return f"{self._host}:{self._http_server.port}"

    @property
    def batcher(self) -> ContinuousBatcher:
        return self._batcher

    def _on_step(self, steps: int) -> None:
        launches = sum(n for name, n in fa.LAUNCHES.items()
                       if name.startswith("flash_decode"))
        self._decode_counts = (steps, launches)

    def _provide_weights(self, rest: str):
        del rest  # one object per replica: weights/current
        with self._weights_lock:
            if self._weights_blob is None:
                self._weights_blob = export_params(self.engine.params)
            blob = self._weights_blob
        # step 0 / etag 0: a replica's weights are fixed for its lifetime
        return 0, len(blob), 0, lambda off, n: blob[off:off + n]

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._server.start()
        self._http_server.start()
        logger.info("replica %s observability http on %s", self.node_id,
                    self.http_addr)
        # warm-start before registering: the fetch can only land on peers
        self._maybe_warm_start()
        self._batcher.start()
        epoch = self._client.serve_register(self.addr, self.engine.slots)
        logger.info("replica %s registered at %s (epoch %s)",
                    self.node_id, self.addr, epoch)
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"serve-hb-{self.node_id}",
            daemon=True)
        self._hb_thread.start()

    def _maybe_warm_start(self) -> None:
        if not hasattr(self.engine, "set_params"):
            return
        try:
            _epoch, replicas = self._client.serve_replicas()
        except (ConnectionError, OSError, RuntimeError) as e:
            logger.info("peer listing for warm start failed: %r", e)
            return
        peers = {r["addr"]: r["node_id"] for r in replicas
                 if r["node_id"] != self.node_id}
        if not peers:
            return

        def reporter(kind, data):
            # the replica's journal, and the master's (on its clock)
            self.journal.record(kind, source=f"replica_{self.node_id}",
                                **data)
            self._client.report_event(kind, data)

        stats = load_weights_from_peers(self.engine, list(peers),
                                        reporter=reporter)
        if stats is not None:
            by_source = stats["by_source"]
            stats["from_node"] = peers[max(by_source,
                                           key=by_source.get)]
        self.warm_start = stats

    def _gauges(self) -> Dict[str, float]:
        steps, launches = self._decode_counts
        gauges = {
            "serve_queue_depth": float(self._batcher.queue_depth()),
            "serve_active_slots": float(self._batcher.active()),
            "serve_decode_steps": float(steps),
            "serve_decode_kernel_launches": float(launches),
            "serve_http_port": float(self._http_server.port),
        }
        if hasattr(self.engine, "stats"):  # the prefix-caching wrapper
            st = self.engine.stats()
            gauges["serve_prefix_hit_rate"] = float(st["hit_rate"])
            gauges["serve_prefix_tokens_saved"] = float(st["tokens_saved"])
            # reuses that fell back to the cold prefill (a port addition)
            gauges["serve_prefix_dropped"] = float(st["dropped"])
        if self.warm_start is not None:
            gauges["serve_weight_load_s"] = float(self.warm_start["seconds"])
            gauges["serve_weight_load_bytes"] = float(
                self.warm_start["bytes"])
            gauges["serve_weight_load_from"] = float(
                self.warm_start["from_node"])
        return gauges

    def _hb_loop(self) -> None:
        # beats land on the cadence grid whatever a beat costs; stop wakes
        # the loop at once
        interval = self._hb_interval_s
        next_beat = time.monotonic()
        while not self._stop_evt.wait(max(0.0, next_beat - time.monotonic())):
            next_beat += interval
            now = time.monotonic()
            if next_beat <= now:  # overran a whole period: skip, no burst
                next_beat = now + interval
            inj = get_injector()
            try:
                if inj is not None:
                    inj.fire(SERVE_REPLICA_SITE, node_id=self.node_id)
                resp = self._client.heartbeat(gauges=self._gauges())
                if resp.action_type == "job_abort":
                    logger.warning("replica %s told to abort", self.node_id)
                    self._stop_evt.set()
            except (ConnectionError, OSError, RuntimeError):
                # an injected kill (InjectedFault and InjectedError are
                # subtypes) or the master unreachable past the beat's
                # retry budget: an undrained, crash-like death either way
                logger.warning("replica %s heartbeat failed; crashing",
                               self.node_id, exc_info=True)
                self.crash()
                return

    def run(self) -> int:
        """Block until drained or aborted (the subprocess entry point)."""
        self._stop_evt.wait()
        return 17 if self.crashed else 0

    def stop(self) -> None:
        self._stop_evt.set()
        self._batcher.stop()
        self._server.stop()
        self._http_server.stop()
        self.recorder.close()
        with self._weights_lock:
            self._weights_blob = None  # a stopped replica serves no weights
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)

    def crash(self) -> None:
        """Crash-like death: no drain, no deregister; in-flight requests
        fail and the router re-routes them."""
        self.crashed = True
        self._stop_evt.set()
        self._server.stop()
        self._http_server.stop()
        self.recorder.close()
        self._batcher.stop()
        if self._on_crash is not None:
            self._on_crash()

    # -- RPC surface (the router's data plane) -----------------------------

    def rpc_serve_generate(self, req: comm.ServeGenerateRequest
                           ) -> comm.ServeGenerateResponse:
        with tracing.span(SpanName.SERVE_GENERATE,
                          source=f"replica_{self.node_id}",
                          request_id=req.request_id) as gspan:
            trace_id = getattr(gspan, "trace_id", None) or ""
            try:
                pending = self._batcher.submit(
                    req.request_id, req.prompt, req.max_new_tokens,
                    rerouted=req.rerouted)
            except BatcherClosed:
                return comm.ServeGenerateResponse(
                    request_id=req.request_id, success=False,
                    message="draining", replica_id=self.node_id)
            except ValueError as e:
                return comm.ServeGenerateResponse(
                    request_id=req.request_id, success=False,
                    message=str(e), replica_id=self.node_id)
            if not pending.done.wait(self._request_timeout_s):
                return comm.ServeGenerateResponse(
                    request_id=req.request_id, success=False,
                    message="timeout", replica_id=self.node_id)
            if pending.error:
                return comm.ServeGenerateResponse(
                    request_id=req.request_id, success=False,
                    message=pending.error, replica_id=self.node_id)
            n_out = max(1, len(pending.tokens) - 1)
            return comm.ServeGenerateResponse(
                request_id=req.request_id, success=True,
                tokens=pending.tokens,
                ttft_s=pending.t_first - pending.enqueue_t,
                tpot_s=(pending.t_done - pending.t_first) / n_out,
                queue_depth=self._batcher.queue_depth(),
                replica_id=self.node_id,
                trace_id=pending.trace_id or trace_id)

    def rpc_serve_drain(self, req: comm.ServeDrainRequest
                        ) -> comm.BaseResponse:
        with tracing.span(SpanName.SERVE_DRAIN,
                          source=f"replica_{self.node_id}",
                          reason=req.reason):
            drained = self._batcher.drain(
                timeout_s=self._request_timeout_s)
            try:
                self._client.serve_deregister(reason=req.reason or "drain")
            except (ConnectionError, OSError, RuntimeError):
                logger.warning("deregister after drain failed",
                               exc_info=True)
            self._stop_evt.set()
            return comm.BaseResponse(success=drained)

    def rpc_serve_ping(self, req: comm.BaseRequest) -> comm.BaseResponse:
        return comm.BaseResponse()


# the directory holding the package: a spawned replica imports it from here
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# stderr lines kept a child, for the error when it dies before registering
_STDERR_TAIL_LINES = 40


def _tee_stderr(pipe, tail: collections.deque) -> None:
    """Copy a child's stderr to ours, keeping its last lines."""
    for raw in iter(pipe.readline, b""):
        line = raw.decode("utf-8", "replace")
        tail.append(line.rstrip("\n"))
        sys.stderr.write(line)
    pipe.close()


class LocalReplicaManager:
    """Subprocess serve scaler for one host: ``scale_to`` is the verb the
    serving autoscaler executes, ``kill_one`` the chaos hammer.

    Takes the reference's arguments, and for ``backend="torch"`` the
    engine's: ``config`` (``tiny`` or ``llama``), ``device`` (default
    ``cuda``, which raises here on a box without CUDA; the toy backend
    takes none). ``seed`` is the seed of the replicas spawned from then
    on. A child that exits before it registers makes :meth:`wait_live`
    raise with its exit code and the tail of its stderr. Each child gets
    a free ``--http-port`` picked here (:attr:`http_ports`, by node id);
    its beat's ``serve_http_port`` is the port it bound (another, when
    the picked one was taken before the child bound it)."""

    def __init__(
        self,
        master_addr: str,
        live_fn: Callable[[], List[Dict]],
        backend: str = "toy",
        slots: int = 4,
        buckets=(8, 16),
        max_new_cap: int = 16,
        cache_len: int = 48,
        heartbeat_interval_s: float = 0.2,
        seed: int = 0,
        step_delay_s: float = 0.0,
        quantize: bool = False,
        prefix_cache: bool = False,
        config: str = "tiny",
        device: Optional[str] = None,
    ):
        if backend == "toy":
            if device is not None:
                raise ValueError("the toy backend serves no model and "
                                 "takes no device")
        else:
            device = str(resolve_device("cuda" if device is None
                                        else device))
        self._master_addr = master_addr
        self._live_fn = live_fn
        self._backend = backend
        self._slots = slots
        self._buckets = tuple(buckets)
        self._max_new_cap = max_new_cap
        self._cache_len = cache_len
        self._hb_interval_s = heartbeat_interval_s
        self.seed = seed
        self._next_node_id = 100
        # toy pacing: drill traffic lasts long enough for a mid-traffic
        # kill to land mid-traffic
        self._step_delay_s = step_delay_s
        self._quantize = quantize
        self._prefix_cache = prefix_cache
        self._config = config
        self._device = device
        self._lock = threading.Lock()
        self._procs: Dict[int, subprocess.Popen] = {}
        self._tails: Dict[int, collections.deque] = {}
        # node ids ever seen live, killed or drained by this manager, and
        # children that exited before they registered: (code, tail)
        self._ever_live: set = set()
        self._ended: set = set()
        self._failed_starts: Dict[int, tuple] = {}
        self._poll_evt = threading.Event()  # pacing only, never set
        self.target = 0
        # node id → the HTTP port its child serves /metrics etc. on
        self.http_ports: Dict[int, int] = {}

    def _cmd(self, node_id: int) -> List[str]:
        cmd = [
            sys.executable, "-m", "dlrover_tpu_torch.serving.replica",
            "--master", self._master_addr,
            "--node-id", str(node_id),
            "--backend", self._backend,
            "--slots", str(self._slots),
            "--buckets", ",".join(str(b) for b in self._buckets),
            "--max-new-cap", str(self._max_new_cap),
            "--cache-len", str(self._cache_len),
            "--hb-interval-s", str(self._hb_interval_s),
            "--seed", str(self.seed),
            "--step-delay-s", str(self._step_delay_s),
            "--http-port", str(self.http_ports.get(node_id, 0)),
        ]
        if self._backend != "toy":
            cmd += ["--config", self._config, "--device", self._device]
        if self._quantize:
            cmd.append("--quantize")
        if self._prefix_cache:
            cmd.append("--prefix-cache")
        return cmd

    def _spawn_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        path = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (_PACKAGE_ROOT + os.pathsep + path if path
                             else _PACKAGE_ROOT)
        return env

    def spawn(self) -> int:
        with self._lock:
            node_id = self._next_node_id
            self._next_node_id += 1
            self.http_ports[node_id] = find_free_port("127.0.0.1")
            proc = subprocess.Popen(self._cmd(node_id),
                                    env=self._spawn_env(),
                                    stderr=subprocess.PIPE)
            tail = collections.deque(maxlen=_STDERR_TAIL_LINES)
            threading.Thread(target=_tee_stderr, args=(proc.stderr, tail),
                             name=f"replica-{node_id}-stderr",
                             daemon=True).start()
            self._procs[node_id] = proc
            self._tails[node_id] = tail
        logger.info("spawned replica subprocess node %s", node_id)
        return node_id

    def _reap(self) -> List[int]:
        """Drop exited children; one that never registered and that this
        manager did not end is a failed start. Returns the live ids."""
        live = {r["node_id"] for r in self._live_fn()}
        with self._lock:
            self._ever_live |= live
            for nid, p in list(self._procs.items()):
                if p.poll() is None:
                    continue
                del self._procs[nid]
                if nid not in self._ever_live and nid not in self._ended:
                    self._failed_starts[nid] = (
                        p.returncode, "\n".join(self._tails.get(nid, ())))
                    logger.error("replica %s exited with %s before it "
                                 "registered", nid, p.returncode)
            return list(self._procs)

    def scale_to(self, n: int, reason: str = "") -> None:
        self.target = n
        alive = self._reap()
        if len(alive) != n:
            logger.info("serve scale_to %s (%s): %s alive",
                        n, reason or "plan", len(alive))
        for _ in range(n - len(alive)):
            self.spawn()
        # a shrink is a drain, newest first: it completes all in flight
        for nid in sorted(alive, reverse=True)[:max(0, len(alive) - n)]:
            self.drain_one(nid, reason=reason or "scale down")

    def drain_one(self, node_id: int, reason: str = "scale down",
                  timeout_s: float = 30.0) -> bool:
        addr = next((r["addr"] for r in self._live_fn()
                     if r["node_id"] == node_id), None)
        with self._lock:
            self._ended.add(node_id)
        if addr is not None:
            RPCClient(addr, timeout_s=timeout_s, retries=0).call(
                "serve_drain", comm.ServeDrainRequest(reason=reason))
        with self._lock:
            proc = self._procs.pop(node_id, None)
        if proc is None:
            return True
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            logger.warning("drained replica %s did not exit; killing",
                           node_id)
            proc.kill()
            proc.wait(timeout=5.0)
        return True

    def kill_one(self, node_id: Optional[int] = None) -> Optional[int]:
        """SIGKILL a replica (the chaos scenario): its victim's node id."""
        with self._lock:
            victims = [nid for nid, p in self._procs.items()
                       if p.poll() is None]
            if not victims:
                return None
            victim = node_id if node_id in victims else victims[0]
            proc = self._procs[victim]
            self._ended.add(victim)
        logger.warning("chaos: SIGKILL replica %s", victim)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10.0)
        return victim

    def live_count(self) -> int:
        return len(self._live_fn())

    def wait_live(self, n: int, timeout_s: float = 60.0) -> bool:
        """Wait until the master sees n live replicas (registering is the
        replica's own act: the manager only owns processes). Raises when
        a child exited before it registered."""
        deadline = time.monotonic() + timeout_s
        while True:
            self._reap()
            with self._lock:
                failed = dict(self._failed_starts)
            if failed:
                nid, (code, tail) = sorted(failed.items())[0]
                raise RuntimeError(
                    f"replica {nid} exited with {code} before it "
                    f"registered; its stderr ended:\n{tail}")
            if len(self._live_fn()) >= n:
                return True
            if time.monotonic() >= deadline:
                return False
            self._poll_evt.wait(0.05)

    def stop_all(self, timeout_s: float = 10.0) -> None:
        with self._lock:
            procs = list(self._procs.items())
            self._procs.clear()
            self._ended.update(nid for nid, _ in procs)
        for _, p in procs:
            if p.poll() is None:
                p.terminate()
        for _, p in procs:
            try:
                p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5.0)


def _build_engine(args, params=None):
    """The engine ``args`` describe, wrapped in the prefix cache when
    asked. ``params`` (torch backend) are weights to serve instead of
    drawing them from ``--seed``."""
    if args.backend == "toy":
        engine = ToyEngine(slots=args.slots, vocab=args.vocab,
                           cache_len=args.cache_len,
                           prefill_delay_s=args.prefill_delay_s,
                           step_delay_s=args.step_delay_s)
    else:
        device = torch.device(args.device)
        config = (tiny_config(args.cache_len, args.vocab, args.dim,
                              args.n_layers)
                  if args.config == "tiny" else LlamaConfig())
        if params is None:
            params = init_params(
                config, torch.Generator(device=device).manual_seed(args.seed),
                device)
        engine = BatchDecodeEngine(params, config, slots=args.slots,
                                   cache_len=args.cache_len,
                                   quantize=args.quantize, device=device)
    return maybe_wrap_prefix_cache(engine,
                                   enabled=args.prefix_cache or None)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("dlrover_tpu_torch serve replica")
    parser.add_argument("--master", required=True)
    parser.add_argument("--node-id", type=int, required=True)
    parser.add_argument("--backend", default="toy", choices=["toy", "torch"])
    parser.add_argument("--config", default="tiny", choices=["tiny", "llama"],
                        help="torch backend: the tiny f32 model, or "
                             "LlamaConfig() in bf16")
    parser.add_argument("--device", default=None,
                        help="the torch backend's device (cuda, cuda:N or "
                             "cpu; default cuda)")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--http-port", type=int, default=0,
                        help="the /metrics, /events and /debug/bundle "
                             "server's port (0: a free one)")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--buckets", default="8,16")
    parser.add_argument("--max-new-cap", type=int, default=16)
    parser.add_argument("--cache-len", type=int, default=48)
    parser.add_argument("--vocab", type=int, default=32)
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hb-interval-s", type=float, default=None)
    parser.add_argument("--step-delay-s", type=float, default=0.0)
    parser.add_argument("--prefill-delay-s", type=float, default=0.0)
    parser.add_argument(
        "--quantize", action="store_true",
        default=env_flag(ConfigKey.SERVE_QUANT, False),
        help="int8 KV cache in the batched engine")
    parser.add_argument(
        "--prefix-cache", action="store_true",
        default=env_flag(ConfigKey.SERVE_PREFIX, False),
        help="radix prefix-cache reuse across requests")
    args = parser.parse_args(argv)
    if args.backend == "toy":
        if args.device is not None:
            parser.error("--device needs --backend torch: the toy backend "
                         "serves no model and uses no device")
    elif args.device is None:
        args.device = "cuda"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.backend == "toy":
        logger.warning("replica %s serves the toy backend: host-side "
                       "tokens, no model, no device", args.node_id)
    replica = DecodeReplica(
        master_addr=args.master, node_id=args.node_id,
        engine=_build_engine(args),
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_new_cap=args.max_new_cap, port=args.port,
        heartbeat_interval_s=args.hb_interval_s, http_port=args.http_port)
    replica.start()
    code = replica.run()
    replica.stop()
    return code


if __name__ == "__main__":
    raise SystemExit(main())

"""Elastic serving drill on the PyTorch port, as one runnable script.

The twin of ``examples/serve_elastic.py`` over ``dlrover_tpu_torch``:

1. the port's master starts with the serve registry on its liveness
   plane and the event journal; ``LocalReplicaManager`` spawns N decode
   replicas as subprocesses, each registering as a SERVE node,
   heartbeating, and continuous-batching requests over its KV cache;
2. the port's router load-balances a closed-loop load over the live
   replicas;
3. the ``serve.replica`` chaos site decides a SIGKILL of one replica
   mid-traffic; the master's connection-drop grace declares it lost, the
   router re-routes its in-flight requests (greedy decode over
   replica-identical weights: no request lost), and the serving
   autoscaler on the ``JobAutoScaler`` tick restores the replica count,
   the replacement warm-starting its weights from the survivor;
4. the result (tokens/s, TTFT p50/p99, serving goodput from the journal,
   kill → detect and kill → restore seconds, the journal's counts) is
   printed as one JSON line.

Run::

    python examples/serve_elastic_torch.py              # LlamaConfig(), cuda
    python examples/serve_elastic_torch.py --backend toy
    python examples/serve_elastic_torch.py --device cpu --config tiny

The default is ``--backend torch --config llama --device cuda``: full
width and depth on one card, with the settings of ``chip_smoke.py``'s
kill drill (``LLAMA_DRILL`` and ``LLAMA_KILL_TRAFFIC`` in
``dlrover_tpu_torch/serving/drill.py``). It exits 0
when no request was lost, every request completed and, with the kill,
the kill was detected and the fleet restored.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from dlrover_tpu_torch.serving.drill import (  # noqa: E402
    LLAMA_DRILL,
    LLAMA_KILL_TRAFFIC,
    run_serving_drill,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="closed-loop elastic serving drill on the torch port")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--backend", default="torch",
                        choices=["toy", "torch"])
    parser.add_argument("--config", default="llama",
                        choices=["tiny", "llama"])
    parser.add_argument("--device", default=None,
                        help="the torch backend's device (default cuda)")
    parser.add_argument("--requests", type=int, default=None,
                        help="default 48 for --config llama, else 24")
    parser.add_argument("--concurrency", type=int, default=None,
                        help="default 8 for --config llama, else 4")
    parser.add_argument("--max-new-tokens", type=int, default=None)
    parser.add_argument("--no-kill", action="store_true",
                        help="skip the mid-traffic replica SIGKILL")
    args = parser.parse_args(argv)
    kw = dict(backend=args.backend, num_requests=24, concurrency=4)
    if args.backend == "torch":
        if args.config == "llama":
            kw.update(LLAMA_DRILL, **LLAMA_KILL_TRAFFIC)
        kw.update(config=args.config, device=args.device or "cuda")
    elif args.device is not None:
        parser.error("--device needs --backend torch: the toy backend "
                     "serves no model and uses no device")
    for key, value in (("num_requests", args.requests),
                       ("concurrency", args.concurrency),
                       ("max_new_tokens", args.max_new_tokens)):
        if value is not None:
            kw[key] = value
    result = run_serving_drill(replicas=args.replicas,
                               kill_mid_traffic=not args.no_kill, **kw)
    # the journal itself stays off the line (its kinds are counted there)
    result.pop("journal_dump", None)
    print(json.dumps(result), flush=True)
    ok = result["lost"] == 0 and result["completed"] == result["requests"]
    if not args.no_kill:
        ok = ok and result["kill_detected"] and result["replicas_restored"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --decode   # the decode kernel (K4) alone
    python3 chip_smoke.py --fold     # the ring fold (K1-K3 at sp = 4) alone
    python3 chip_smoke.py --tp-fold  # the tp fold (K1-K3 at tp = 4) alone
    python3 chip_smoke.py --serve    # the serving replica (phase 7) alone
    python3 chip_smoke.py --serve-elastic  # the elastic serving plane (9)
    python3 chip_smoke.py --elastic  # the agent's fault drill (phase 8)
    python3 chip_smoke.py --timer    # the device timer's checks alone
    python3 chip_smoke.py --straggler  # the straggler leg alone
    python3 chip_smoke.py --moe      # the Mixtral-class MoE phase alone
    python3 chip_smoke.py --moe --control dk0  # ... with a kernel made wrong
    python3 chip_smoke.py --timer-ab # phase 6's step without and with it
    python3 chip_smoke.py --copy-probe  # the replica store's frame copy
    python3 chip_smoke.py --multi 4  # the elastic loop across 4 cards
    python3 chip_smoke.py --node-drill 4  # its node drill alone
    python3 chip_smoke.py --parallel 4  # ring, Ulysses, GPipe, MoE, fsdp, tp
    python3 chip_smoke.py --parallel 4 --control ring_drop  # ... broken

Builds the port's CUDA kernels from ``dlrover_tpu_torch/ops/csrc`` and the
device timer from ``dlrover_tpu_torch/tpu_timer`` and runs twelve phases,
each printing one JSON line (the serving runs one each); ``timer`` runs
after phase 1, phase 7 after phase 3, on the same weights, phase 9 after
phase 7 (its replica stopped and the weights freed), ``moe`` after phase 9,
phase 8 after phase 6, ``straggler`` last:

1. ``kernels`` — each kernel against its plain PyTorch version on the card,
   in bf16 at its path's shapes, with the error, the kernel's time, the
   plain version's time and, as a yardstick only, the time of PyTorch's
   ``scaled_dot_product_attention`` on the same inputs (forward, decode)
   or of its autograd backward (for the backward pair; the port never
   calls it). The forward (K1) is also held where its 128 x 128 tiles end
   (S 127/128/129, Sq 1, Sk 64, Sk 0), on ragged, cross and head_dim-64
   shapes and with q passed transposed, and timed at both prefill shapes
   and the training shape with its TFLOP/s. The backward pair (K2, K3)
   is held likewise where its tiles end (S 127/128/129, Sq 1, Sq 300 over
   Sk 64, Sk 0 and Sq 0 exactly 0), on ragged, cross, head_dim-64 and
   lse-cotangent shapes and with q and do transposed (bitwise equal to
   contiguous), must give bitwise-equal results on two launches, and is
   timed at the training shape with its TFLOP/s and the time of the
   ``_delta`` pass before it. The decode kernel (K4, bf16 and int8 cache)
   is held where its 256-key splits and 64-key tiles end (positions 0,
   255, 256, 257, T - 1 and past the cache, T 4100, G 1 and 8, Dh 64, one
   row of T 32768), must give bitwise-equal results on two launches, and
   is timed warm and with L2 flushed beside SDPA under a pinned backend.
   The ring fold: what rank 3 of ring attention at sp = 4 computes (B1
   H32 D128, 4 chunks of 4096), composed on one card from the ring's own
   steps (K1 causal on its chunk, K1 non-causal with lse on each earlier
   chunk, ``_merge_partials``), held with its backward (K2 and K3 with a
   non-zero lse cotangent) against K1-K3 causal over the whole 16384 and,
   at 4 x 1024, against the plain fold, at FOLD_SP launches of each
   kernel, and timed beside the whole sequence. The tp fold: one
   ``LlamaConfig()`` layer on 2 x 2048 tokens, forward and backward, as
   TP_FOLD = 4 tensor-parallel pieces on one card (each the model's
   attention on its 8 q and 2 KV heads through K1-K3 and its MLP on its
   quarter of the columns, the partials summed in f32 as *g* sums them,
   the cotangents of the pieces' inputs as *f* does), held against the
   whole layer through the same kernels within TP_FOLD_REL_TOL (the
   layer's contribution, dx less dy, every weight's grad);
``timer`` — the device timer (``dlrover_tpu_torch/tpu_timer``, built with
   the host C++ compiler, its hand-declared CUDA prototypes checked against
   the toolkit's headers) in a child of this script under ``LD_PRELOAD``
   with its hook library, the engine on a free port and a hang timeout of
   3 s. Held: 20 bf16 ``torch.matmul``s at the train step's MLP shape
   (16384 x 4096 . 4096 x 11008) land in the mm family with m, n, k
   captured, the hook's mean latency and ``_FLOPS`` within 5% of CUDA
   events taken by torch around the same loop; a 1 GiB pinned D2H and H2D
   copy land in the memory family with exactly 2^30 bytes each; a one-rank
   NCCL ``all_reduce`` of 256 MiB lands in the coll family with its count
   and bandwidth; a GEMM inside CUDA graph capture neither faults nor
   counts; a ``torch.cuda._sleep`` spin of twice the timeout with one GEMM
   behind it raises ``XPU_TIMER_COMMON_HANG`` within the timeout plus one
   watchdog tick, the hang file names the stuck op and its stream, the
   faulthandler file holds the main thread's stack, and the gauge reads 0
   once the spin ends; the daemon (``start_daemon``) serves the child's
   families on ``/metrics`` and the GEMM events on ``/dump_trace``;
   ``replay`` of the top 3 GEMMs reaches at least 0.8 of the recorded rate;
   a ``request_profile`` to the child's ``ProfileListener`` returns a
   ``torch.profiler`` trace holding CUDA kernel events. Prints the host's
   cost per hooked call (1000 small GEMMs, the hook on and off), the
   copies' GB/s, replayed and recorded TFLOP/s, and the card;
2. ``generate`` — ``decode.generate`` on ``LlamaConfig()`` at full width
   and depth (the Llama-2-7B shape with 8 KV heads, random weights from a
   seed), batch 8, greedy: (a) bf16 cache, prompt 1024, 64 new tokens,
   preallocated 4096 slots; (b) int8 cache, prompt 2048, 32 new tokens,
   tight cache. Both prefill through the flash-forward kernel and decode
   through the decode kernel; the launch counts must show it. Prefill and
   first-step logits are compared with the dense path. A fresh memory
   accountant sweeps the card after it (``observability/memory.py``:
   against the allocator's allocated bytes, reserved beside them):
   ``decode.generate`` owns no claim, so its weights and cache are the
   unattributed bytes; prints them, the headroom and the peak;
3. ``engine`` — ``BatchDecodeEngine`` with an int8 cache, 8 slots, 4096
   cache slots, serving 16 requests of ragged lengths with slot reuse;
   every step must go through the decode kernel, ragged or not. Held: the
   engine's ``kv_cache`` claim equals its cache tensors' bytes exactly;
   ``dlrover_compile_total{fn}`` equals the engine's distinct shape keys
   of each kind (``engine.prefill``, ``engine.insert``, ``engine.step``)
   and the steady traffic journals no recompile storm. Prints each miss's
   seconds (a shape key's first call) and the ledger's sweep;
4. ``train`` — ``ElasticTrainer.train_step`` with ``adamw(3e-4)`` on
   ``LlamaConfig()`` at full width and 8 layers (bf16 params, f32 grad
   accumulators and moments), remat "dots", global batch 8 as 2 micro
   batches of 4, sequence 2048, fed by the port's sampler and loader: 3
   counted steps whose launches must be K1 = 2·L·accum (forward and remat
   recompute) and K2 = K3 = L·accum a step; one micro step on the kernel
   path against the dense path; a fixed batch whose loss must fall over 3
   steps; a profile of one step, tokens/s and MFU. Held: the trainer's
   ``params`` and ``opt_state`` claims equal its state's bytes exactly
   (with the step counter, the bytes phase 5 saves) and its
   ``activations`` claim the f32 accumulators; one step signature. Prints
   the sweep (unattributed bytes, headroom, reserved) and the ledger's
   peak beside ``torch.cuda.max_memory_allocated``.

5. ``ckpt`` — Flash Checkpoint on the train phase's state cut to its
   first CKPT_LAYERS = 4 layers (bf16 params, f32 moments: 9.7 GB; 16.8
   GB at 8), after ``worker.init`` (NCCL, one rank) and with the state as
   DTensors on a mesh of 1. The free bytes of ``/dev/shm`` and of the
   storage directory come first; when the state does not fit both, the
   phase keeps the most layers that do and says so. A ``save_to_memory`` is followed at once by a ``train_step``, which
   writes the state in place: the snapshot must hold the values from
   before the step. Then a ``save_to_storage``, a ``load`` from shm and
   one from storage, each bitwise equal to the saved state, leaf by leaf,
   on the card. Prints the save's training pause, the drain, storage and
   restore rates, and the step time with and without a save in flight.
   Held (``ckpt_ledger``): the shm segment's ``staging`` claim equals its
   size while mapped and is 0 once it is released;
6. ``resume`` — a kill drill across processes with
   ``examples/llama_elastic_pretrain_torch.py``'s ``train`` in child
   processes: ``LlamaConfig()`` widths, 2 layers, global batch 8,
   sequence 2048, memory saves every step, storage every 5. Two unkilled
   runs of 10 steps must agree bitwise; a third SIGKILLs itself once step
   7's memory frame is sealed (beside the second unkilled run, on the
   same card: the step times and gaps come from the first run and the
   resumed one), and a fourth must resume from shm at step 7 (not from
   storage's step 5) and give the unkilled run's losses for steps 8-10.
8. ``elastic`` — the port's ``dlrover-run`` (``python -m
   dlrover_tpu_torch.agent.run --standalone --nproc-per-node=1
   --max-restarts=4 --save-at-breakpoint --ckpt-replica=2``, its master
   in the agent process; started as ``python -c`` around ``run.main``,
   which then checks the agent's modules) drives the twin at phase 6's
   sizes on the card, every incarnation released from a warm spare (the
   agent's pool, spawned after the timer's build), each sealed frame
   pushed to the agent's replica store, through four
   faults keyed on the agent's restart count: a SIGKILL once step 3's
   frame is sealed (the agent's breakpoint save, then a restore from shm
   at 3); a torn step-6 frame (``DLROVER_FAULT_SCHEDULE=
   "shm.write:torn@step=6"``) and a SIGKILL after it (the saver refuses
   the frame by its CRC, the restore comes from storage at 5 and replays
   6); a device wedge after step 8 outside the training span: a
   ``torch.cuda._sleep`` spin longer than the drill with a hooked GEMM and
   an ``.item()`` behind it. The agent runs with ``--tpu-timer`` (its
   workers preload the device timer's hook, ``TPU_TIMER_HANG_TIMEOUT`` 10 s,
   below the hang rule's downtime), so the hook's watchdog raises
   ``XPU_TIMER_COMMON_HANG``, the agent's beats carry it, and the master's
   hang rule, with ``hang_downtime_s`` 1.5 × phase 6's longest
   step-report gap + 10 s, hears the node's vote and queues a wedged
   ``RESTART_WORKER``; the restore comes from shm at 8; once the agent's
   store holds step 9's frame, the worker unlinks its own segment and
   SIGKILLs itself: the breakpoint save finds no frame, and the restore
   writes step 9 back from the store and restores it from shm. Held: the
   agent exits 0 after 4 restarts, each restore's medium and step, step 9
   written back from the store, the store holding step 6 (torn: its copy
   fails its CRCs and is refused) and step 9 at their kills, storage
   holding 3, 5 and 8 and never 6 or 9, every step's last loss equal to
   phase 6's unkilled loss within the unkilled runs' spread, K1-K3
   launched in every incarnation, no JAX module in the agent or any
   worker; every incarnation a warm spare's (torch imported at the
   script's first line, the spare's times in its environment, every spawn
   event warm) with no CUDA context at the script's first line, and no
   process on the card (``nvidia-smi --query-compute-apps=pid``, polled
   each second, when it shows this namespace's pids) but this one and the
   released workers, each after its release; and the
   hang loop: the beats carried the gauge with non-zero
   ``XPU_TIMER_MM_KERNEL_*`` families, the master's verdict was
   ``training_hang`` on node 0's vote, the daemon's stack dump holds the
   wedged worker's Python stack, a profile was requested, and the
   SIGKILLed spinning worker's card trained the next incarnation; and the
   attribution plane, read from the standalone master's ``/heartbeats``,
   ``/memory`` and ``/events`` while the run lasts: every beat that
   reported a step carried op telemetry and a memory ledger; the last
   beat of each faulted incarnation carried the compute count its worker
   read, at its last publish, both from its op telemetry and from the mm
   family of its device-timer ``/metrics`` (one native engine);
   ``/memory`` names rank 0 on node 0; no straggler or hang verdict at
   world 1; a ``mem.pressure`` fault in the first incarnation's worker
   is journaled as ``memory_pressure`` and its bundle holds
   ``memory.json``, which ``python -m
   dlrover_tpu_torch.observability.report`` renders, and the report of
   the run's journal counts one incident a fault (four). Prints
   each fault's detect (fault → the agent acts) and restart (fault → the
   next incarnation's first step) seconds and restore, each
   incarnation's pre-import and release-to-script seconds, the pushes'
   rate and the store's lag in steps, the steps' own time with the
   pushes (each from the end of the previous step's waits; kill and
   storage steps left out) against phase 6's, the gauge's rise
   after the wedge, the median step time under the timer against phase
   6's, the rendezvous rounds, each incarnation's start-up seconds, and
   ``wall_s`` and ``goodput_pct`` (``compute_goodput`` over the run's
   event files). The agent's saver waits 10 ms at every commit
   (``storage.commit:delay=10ms``, an agent-side fault) and its flight
   recorder, at cooldown 0, writes a chaos bundle at each; held: those
   bundles exist and one worker's ``ckpt.persist_request`` trace is the
   trace of the saver's ``ckpt.persist`` in them (the context rode the
   SAVE event over the agent's queue).
7. ``serve`` — the serving replica behind the port's master servicer and
   router: replica A in this process (``DecodeReplica`` around the first
   SERVE_LAYERS = 16 layers of phase 2's weights: int8 cache, 8 slots,
   4096 cache slots, buckets 512/1024/2048, prefix cache with a 2 GiB
   budget) and replica B, a subprocess through ``python -m
   dlrover_tpu_torch.serving.replica --config llama --n-layers 16`` with
   seed + 1, which warm-starts from A over the fabric. 32 requests from 4
   clients through the router: 8 shared 512-token system prompts, seeded
   suffixes of 16-1024 tokens and 16-48 new tokens, every prompt sent
   twice. Held: no lost or failed request; every step on A one K4 launch a
   layer; A's and B's tokens reproduced by a teacher-forced dense forward
   (TEACHER_AGREE_MIN); one cold prompt gives the same tokens on A and B
   and other tokens on a fresh seed + 1 model; a prefix hit on A or B, and
   A's hits against their cold prefill, and no reuse dropped to a cold
   prefill on A or B; TTFT on a hit against a miss. Then
   ``decode_window`` (bf16 and int8 cache) against K sequential
   ``decode_step``s at full width over 16 rows x 8 windows, on the
   continuation the steps choose and on random tokens: logits within
   LOGITS_REL_TOL, argmax within TEACHER_AGREE_MIN, and no argmax miss
   where the steps' top-2 gap exceeds the largest logit error; and
   speculative decoding (prompt 512, 64 new tokens, k 4) with the target
   as its own draft (acceptance at least 0.9) and with a 2-layer draft of
   another seed, against stock ``decode.generate``. The observability
   spine, after the 32 routed requests: A's ``/metrics`` (its own
   registry: the TTFT count equals A's completed requests, every exemplar
   a trace in this process's ring), ``/events`` (its prefix hits) and
   ``/debug/bundle``, and B's bundle (the reference's eight files each);
   every request one trace of the six ``serve.*`` spans (B's from its
   bundle), queue + prefill + first step within 0.25 s of its TTFT; and
   a span's cost with tracing on and off. Held too: A's
   ``dlrover_compile_total{fn}`` equals its engine's distinct shape keys
   of each kind (each miss's seconds printed); no storm is journaled but
   on ``engine.prefill_sfx``, whose key holds a prefix hit's matched
   length (the second pass's replayed prompts spread it), and there
   attributed to ``seq_len``;
   and B's ``staging`` claim (its warm start's fabric session) reads 0 on
   its ``/metrics`` after the warm start with a watermark of exactly the
   blob's bytes.
9. ``serve_elastic`` — the elastic serving plane
   (``dlrover_tpu_torch/serving/drill.py``): the port's master with its
   journal, router, ``JobAutoScaler`` + ``ServingOptimizer`` and
   ``LocalReplicaManager``, replicas as subprocesses through
   ``python -m dlrover_tpu_torch.serving.replica --config llama``. (a)
   ``run_serving_drill``: two ``LlamaConfig()`` replicas at full width and
   SERVE_KILL_LAYERS = 8 layers (one seed, int8 cache, 8 slots,
   cache_len 2048, buckets 256/512/1024), 48 requests from 8 clients
   (prompts 64/200/500/1000, 32 new tokens), a SIGKILL of a replica with
   requests in flight once a third have completed (the ``serve.replica``
   chaos site's fault reported after it); the replacement is spawned
   with another seed, so
   only the survivor's weights give it the survivor's tokens. Held: no request lost or failed, all completed;
   the kill detected, at least one re-route, the fleet restored by the
   autoscaler; the journal's ``fault_injected``, ``serve_replica_lost``
   and one ``serve_scale``; no live replica declared dead; the restored
   replica warm-started from the survivor with the bytes of its blob, and
   a probe prompt giving it the survivor's tokens; on every replica, K4
   launches = 32 × its decode steps (each replica's beat carries both).
   Prints detect and restore seconds, the warm start's seconds and GB/s,
   tokens/s, TTFT p50/p99, serving goodput and re-routes. (b)
   ``run_traffic_drill``: one replica, at most two, under the reference
   drill's bursty ramp (30 rps over 4 s) with full-width prompts (64-1024
   tokens, shared-prefix fraction 0.6, 16-32 new). Held: a grow
   journaled, an SLO burn alert, no request lost, all completed, K4 one
   launch a layer a step. Prints ``slo_lead_s`` and TTFT p99. In both
   drills each live replica's ``/metrics`` is scraped over HTTP (a free
   ``--http-port`` from the manager; a timeout and retries): its decode
   steps and K4 launches equal its last beat's. (a) also holds the
   master's ``node_fault`` bundle of the kill (its manifest names the
   victim, its journal the loss) and prints the replicas' order of
   registration and the peer each warm-started from, on the journal's
   clock (ROADMAP C12).

``moe`` (after phase 9) — the Mixtral-class MoE path
   (``models/moe.py``) at Mixtral 8x7B widths (dim 4096, 32/8 heads,
   head_dim 128, ffn 14336, 8 experts, top-2, vocab 32000, capacity 1.25,
   bf16, random weights from a seed), its depth cut to fit one card:
   serving at 8 layers (11.87B parameters, 23.7 GB): the port's routing
   and expert FFN (``moe._route``, ``_moe_ffn``) of the first and last
   layer against the reference's one-hot dispatch/combine form written
   out here (``moe_route_check``: the dispatch equal entry for entry);
   the sequence-parallel routing fold (``moe_sp_fold``): one 4 x 2048
   token sequence routed whole and as 4 sp chunks through the
   gathered-ids path, experts, slots and kept flags equal exactly;
   ``decode.generate``,
   batch 8, prompt 1024, 32 new tokens, on the bf16 cache (4096 slots)
   and on the int8 cache, each with K1 = L launches for the prefill and K4
   = L a decode step exactly; the kernel route's prefill and first step
   against the plain route's (dense attend, no decode kernel), with the
   routing decisions that differ between them (route flips) printed and
   held below MOE_FLIP_SHARE_MAX, the logits of the rows that routed alike
   at LOGITS_REL_TOL, no greedy miss where the plain route's top-2 gap
   exceeds the error, both routes' greedy tokens printed; then the engine
   as phase 3 (int8, 8 slots, 4096 slots, 8 ragged requests, K4 = L a
   step), its teacher a one-slot engine on the plain route (bf16 cache,
   dense attend; the engine's routing groups), teacher-forced, at
   MOE_TEACHER_AGREE_MIN with the step route flips printed; the choices
   its prefills dropped at capacity are printed. Training at 2 layers (3.16B parameters, a 44.3 GB state
   with f32 moments and accumulators): 3 ``ElasticTrainer`` steps, global
   batch 8 × 2048 as 2 micro batches of 4, remat "dots", K1 = 2·L·accum
   and K2 = K3 = L·accum a step exactly, one micro step on the kernel path
   against the dense path (loss and every grad leaf's norm, with the route
   flips), MFU counted by active parameters (the router and two experts a
   layer), the peak memory. Prints the phase's seconds and the card.
``straggler`` (after phase 8) — ``examples/chaos_goodput_torch.py
   --device cuda --straggler-only --tpu-timer``: a port master and two
   port agents of one worker each on this card (their world over gloo:
   NCCL refuses two ranks on one device), every step an all-reduce on the
   host group inside a collective span and four hooked bf16
   ``torch.matmul``s at the train step's MLP shape inside the compute
   span; agent 1's worker sleeps 0.25 s a step inside its own compute span
   (``step.compute:delay=0.25@times=30``). Held: the master's skew monitor
   journals ``straggler_detected(rank=1, cause=compute)`` with a ratio
   above 2 while rank 1 is alive and none before the delay; the straggler
   rule's ``STACK_DUMP`` reached agent 1, whose evidence file holds the
   worker's Python stack and whose ``torch.profiler`` trace of the slow
   worker was taken on its main thread between steps and holds the delayed
   steps' GEMMs (cuBLAS kernels and ``aten::mm`` ops, at least one step's
   four); ``dlrover_skew_ratio`` is above 0 on a
   mid-drill ``/metrics``; each rank's hook timed exactly 4 GEMMs a step
   and its compute class holds them; both agents exit 0 (the dump and the
   profile do not take a worker down). Prints the detect seconds (the
   delay's start → the verdict) and the ratio.

Then one JSON line with every kernel's numbers, the card's name and power
limit from ``nvidia-smi``, and, last, ``{"ok": true, "device": ...}``.
``--timer`` runs the ``timer`` phase alone, with no result line;
``--straggler`` the straggler leg alone; ``--moe`` the ``moe`` phase alone,
and ``--moe --control NAME`` with one kernel made wrong (MOE_CONTROLS),
exiting 0 only when every check that runs that kernel failed;
``--timer-ab`` runs phase 6's unkilled child four times, without and with
the device timer in turns, and prints each run's median step.
``--decode`` builds K4 alone and runs only its rows, with no result line:
the quick loop for work on that kernel. ``--serve`` builds the kernels and
runs phase 7 alone, with no result line; ``--serve-elastic`` phase 9
alone. ``--elastic`` runs phase 8
alone, held against its own unkilled run, with no result line.
``--multi N`` runs the twin across N cards of one host (fsdp N, NCCL, each
rank saving its own shards): its losses and grad norms against one card's
(step 1 at the trainer tests' limits, later steps looser), two unkilled
runs against each other, phase 6's drill across the ranks, and the node
drill: a port master in this process and two port agents of N/2 workers
with ``--ckpt-replica 2``, agent 1's process group SIGKILLed once
storage holds step 5 and node 0's replica store holds both nodes' frames
at one step past it; the survivor at N/2 ranks with twice the
accumulation steps, its live reshard aborted on coverage (journaled),
restored on every rank from the peer frames in node 0's store at that
step; agent 1 back and every rank of the world at N restored by live
reshard from node 0's frames (node 1's ranks over the fabric), no rank
reading storage after the kill; the losses against the unkilled run at
the later-step limits; every rank prints its restore (the reshard's
local and remote bytes, the seconds) and rank 0 the pushes; its agents
with ``--tpu-timer`` so the beats carry the
hooked NCCL all-reduces' entry markers: before the kill the skew monitor
shows every rank at one collective count and no hang; no result line.
``--node-drill N`` runs the node drill alone, held against its own
unkilled run across N cards. ``--parallel 4`` trains PARALLEL_LAYOUTS
across 4 cards (ring and Ulysses at sp 4 on 1 x 32768 tokens, GPipe at
pp 4 on 16 x 2048 with each stage on its own layers, ``LlamaConfig()``
widths; the MoE at ``MoEConfig()`` widths and 2 layers at ep 4 on 8 x
2048, each card on its own 2 experts, and at ep 2 x sp 2 with the ring
on 1 x 16384, its routing groups spanning both chunks; the train
phase's step, 8 layers on 8 x 2048 as 2 micro batches of 4, at fsdp 4,
tp 4 and fsdp 2 x tp 2, and the MoE's at ep 2 x fsdp 2, each card
computing on its own blocks: ``local_axes`` holds fsdp and tp, each
layer gathers its fsdp blocks in its forward and its recompute, and K1-K3
run on the card's H/tp heads; the MoE's at ep 2 x tp 2, each card on its
halves of its 4 experts' FFN; 3 ``ElasticTrainer`` steps each, NCCL)
against one card's run of the same steps (layouts of the same model and
batch share one): each rank's K1-K3 launches at its layout's formula,
the ranks at
one loss and grad norm, each step's loss and grad norm and every leaf's
step-1 grad norm within the PARALLEL_* limits (MOE_PARALLEL_* with the
share of step 1's routing decisions that flipped for the MoE layouts);
it prints step time, tokens/s and peak memory a card beside one
card's; no result line. ``--parallel 4 --control NAME`` breaks one
layout's communication (PARALLEL_CONTROLS) and exits 0 only when that
layout's readings failed and its launches held. ``--fold`` runs the ring
fold alone, ``--tp-fold`` the tp fold and its control (a fold that drops
one piece, which must exceed TP_FOLD_REL_TOL). Any
mismatch, refused launch or fault exits non-zero. Without CUDA the script
exits non-zero and prints no result.

TF32 is switched off for matmuls and cuDNN, so f32 reference products on
the card are full f32.
"""

import time as _time

# this script's first line ran: a worker released from a warm spare finds
# torch imported already (phase 8 and the node drill print both)
_SCRIPT_T0 = _time.time()
_WARM_START = "torch" in __import__("sys").modules
# a spare must hold no CUDA context before its release
_CUDA_AT_FIRST_LINE = (_WARM_START and __import__("sys").modules[
    "torch"].cuda.is_initialized())

import atexit
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dlrover_tpu_torch import worker
from dlrover_tpu_torch.models import decode, llama, moe
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.parallel import (
    collectives,
    pipeline,
    ring_attention,
    ulysses,
)
from dlrover_tpu_torch.parallel.mesh import build_mesh, plan_coords, plan_mesh
from dlrover_tpu_torch.parallel.sharding import (
    dtensor_spec,
    mesh_coords,
    mesh_sizes,
    replica_axes,
    shard_tree,
)
from dlrover_tpu_torch.serving.engine import BatchDecodeEngine
from dlrover_tpu_torch.trainer.data import (
    ElasticDataLoader,
    ElasticDistributedSampler,
    stack_microbatches,
)
from dlrover_tpu_torch.trainer.elastic import (
    ElasticTrainer,
    global_norm,
    make_train_state,
)
from dlrover_tpu_torch.trainer.optim import adamw, tree_leaves, tree_unflatten

# H100 SXM peaks (NVIDIA data sheet, dense): the roofline for bound_ms
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Kernel vs plain version (o of K1 and K4; dq, dk, dv of K2 and K3), both
# bf16 outputs compared in f32, element by element:
#   |err| <= RTOL * |ref| + ROW_ATOL * rms(ref row) + FLOOR * rms(ref),
# and over the whole output ||err|| <= REL_L2 * ||ref||. A row is one
# head_dim vector: a query row of o and dq, a key row of dk and dv. The two
# sides round their results to bf16 separately (2^-8 relative: the RTOL
# term). The kernels also feed p (and ds) to their products in bf16 (2^-9
# relative each) and sum in another order; those errors add with random
# signs over the row's terms, to about 1e-3 of the row's own size and, in
# the far tail of some 10^7 elements, to nearly 1e-2 of it (ROW_ATOL keeps
# 2x room). So an element near 0 is held to its row's size and not to the
# tensor's largest value: in a causal sequence the last rows are ~sqrt(1/S)
# the size of the first, and a fault confined to them must not hide under
# the first rows' scale. FLOOR only covers rows that are 0 up to f32
# rounding (dq of the first causal row, where ds = p * (dp - delta) cancels
# exactly).
KERNEL_RTOL, KERNEL_ROW_ATOL, KERNEL_FLOOR = 2e-2, 2e-2, 1e-3
KERNEL_REL_L2 = 1e-2
# lse is f32 on both sides from the same bf16 products: only the summation
# order and exp/log rounding differ
LSE_ATOL = 1e-3

# Kernel path vs dense path of the whole 32-layer model, logits compared in
# f32 relative to the reference's largest logit. Both paths are bf16; they
# round attention probabilities at different points (the kernel before its
# PV product in its own order, the dense attend after an f32 softmax), and
# the int8 decode folds the scales in f32 where the dense path dequantizes
# to bf16 first. Those differences pass through 32 residual layers.
LOGITS_REL_TOL = 5e-2
# Engine tokens held against a teacher-forced dense forward of the same
# sequence (bf16 weights, exact bf16 k/v instead of the int8 cache): the
# share of greedy tokens the forward's argmax reproduces.
TEACHER_AGREE_MIN = 0.9

SEED = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# cycles the card idles before a timed window (about 0.3 ms per call timed)
# while the host queues the calls, so the events measure the device's work
# and not the host's: the decode kernel's wrapper takes longer on the host
# than the kernel takes on the card
QUEUE_AHEAD_CYCLES = 500_000


def _queued_ms(fn, iters, cycles, before=None):
    """Device time per call of ``iters`` calls of ``fn`` queued while the
    card idles ``cycles`` (after ``before()``, untimed). Taken again with
    twice the idle while the card reached the window's first event before
    the host had queued the last call (the window would then hold host
    time); fails after four tries."""
    for _ in range(4):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        queued_in_time = not start.query()
        end.record()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
        print(f"timing: window retaken with {cycles} idle cycles",
              file=sys.stderr, flush=True)
    raise AssertionError(
        f"timing: the host still queued calls after the card had idled "
        f"{cycles // 2} cycles; the window would measure the host")


def time_ms(fn, iters, device, queue_ahead=True):
    """Mean time of ``fn`` over ``iters`` calls after one warm-up call:
    CUDA events on the card, the host clock elsewhere. With
    ``queue_ahead`` the calls are queued while the card idles, so the
    time is the device's; without it they run back to back as the host
    issues them, so it is what a caller that waits on each call pays,
    host included."""
    fn()
    _sync(device)
    if device.type == "cuda" and queue_ahead:
        return _queued_ms(fn, iters, QUEUE_AHEAD_CYCLES * iters)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(fn, iters, device, top=5, match=None, check_reader=False):
    """``fn`` run ``iters`` times under ``torch.profiler`` (device activity
    only, so the host pays little for the tracing): wall time and device
    kernel time per call, the device's idle share, the ``top`` kernels
    that took most of it and, with ``match``, the device time per call of
    the kernels whose name contains it. With ``check_reader`` the same
    trace is also read through ``key_averages()`` (its busy time and top
    kernels, under ``key_averages``): the profiler's own sums, beside
    which the trace reader's are printed (the MoE phase's profiles; over
    a long trace it takes minutes)."""
    from torch.profiler import ProfilerActivity, profile

    act = (ProfilerActivity.CUDA if device.type == "cuda"
           else ProfilerActivity.CPU)
    _sync(device)
    with profile(activities=[act]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        wall_s = time.perf_counter() - t0
    # the device's events straight from the trace, summed by name (what
    # key_averages() gives as their self device time, without building
    # its event tree: over a serving pass that took minutes of host time)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    busy_s = sum(by_name.values()) / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = dict(
        steps=iters, wall_ms=wall_s * 1e3 / iters,
        device_busy_ms=busy_s * 1e3 / iters, idle_share=1 - busy_s / wall_s,
        top_kernels_ms=[[name[:80], ns / 1e6 / iters]
                        for name, ns in ranked],
    )
    if match is not None:
        out[f"{match}_ms"] = sum(ns for name, ns in by_name.items()
                                 if match in name) / 1e6 / iters
    if check_reader:
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        out["key_averages"] = dict(
            device_busy_ms=sum(e.self_device_time_total for e in kernels)
            / 1e3 / iters,
            top_kernels_ms=[[e.key[:80], e.self_device_time_total / 1e3
                             / iters] for e in kernels[:top]])
    return out


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row carries the script's seconds so far
    (``t_s``), from which the phases' times follow."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def _check_close(name, out, ref, row_atol=KERNEL_ROW_ATOL):
    """Hold a kernel's output against its plain version at the KERNEL_*
    tolerance (``row_atol`` in place of KERNEL_ROW_ATOL where given).
    Returns the largest |err|, ||err|| / ||ref||, and the largest share of
    its element's limit that an error takes."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    row_rms = ref.square().mean(dim=-1, keepdim=True).sqrt()
    lim = (KERNEL_RTOL * ref.abs() + row_atol * row_rms
           + KERNEL_FLOOR * float(ref.square().mean().sqrt()))
    bad = int((err > lim).sum())
    rel_l2 = float(torch.linalg.vector_norm(err)
                   / torch.linalg.vector_norm(ref))
    share = float((err / lim).max())
    if bad or rel_l2 > KERNEL_REL_L2 or not torch.isfinite(out).all():
        raise AssertionError(
            f"{name}: {bad} elements outside |err| <= {KERNEL_RTOL}*|ref| + "
            f"{row_atol}*rms(row) + {KERNEL_FLOOR}*rms(ref) (worst "
            f"{share:.3g} of its limit), ||err||/||ref|| {rel_l2:.3g} "
            f"(limit {KERNEL_REL_L2}), max err {float(err.max()):.4g}")
    return dict(max_abs_err=float(err.max()), rel_l2=rel_l2,
                share_of_limit=share)


def _worst(checks):
    """The largest of each number over several _check_close results."""
    return {key: max(c[key] for c in checks) for key in checks[0]}


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------


def _fwd_case(gen, device, B, H, Sq, Sk, D, causal, transposed_q=False):
    """K1 against its plain version on one case; ``transposed_q`` passes q
    as the ``(B, S, H, D) -> (B, H, S, D)`` view the models pass, and the
    result must also equal the one for the same q laid out contiguously.
    With Sk = 0 the plain version has no key to reduce over: every row must
    then give o = 0 and lse = -1e30 exactly."""
    shape = (B, Sq, H, D) if transposed_q else (B, H, Sq, D)
    q = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    if transposed_q:
        q = q.transpose(1, 2)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    tag = (f"flash_fwd B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal}"
           + (" q transposed" if transposed_q else ""))
    if Sk == 0:
        if not (torch.equal(o, torch.zeros_like(o))
                and bool((lse == fa.NEG_INF).all())):
            raise AssertionError(f"{tag}: rows with no key must give o = 0 "
                                 f"and lse = {fa.NEG_INF}")
        return (q, k, v), dict(max_abs_err=0.0, rel_l2=0.0,
                               share_of_limit=0.0)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal)
    check = _check_close(tag, o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"{tag} lse: max err {lse_err:.4g} > {LSE_ATOL}")
    if transposed_q:
        o2, lse2 = fa.flash_attention(q.contiguous(), k, v, causal=causal,
                                      return_lse=True)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{tag}: differs from the contiguous q")
    return (q, k, v), check


def _visible_pairs(Sq, Sk, causal):
    if not causal:
        return Sq * Sk
    rows = torch.arange(Sq)
    return int(torch.clamp(rows + 1, max=Sk).sum())


def _bwd_case(gen, device, B, H, Sq, Sk, D, causal, with_dlse=False,
              transposed=False):
    """K1 forward, then K2 + K3 against the plain backward on the same
    (o, lse, do, dlse); returns the inputs and the check of each output.
    ``transposed`` passes q and do as the ``(B, S, H, D) -> (B, H, S, D)``
    views the models pass, and the result must also equal, bit for bit, the
    one for the same values laid out contiguously. With Sk = 0 (no key) dq
    must be exactly 0, and with Sq = 0 (no query) dk and dv."""

    def rows(s):
        shape = (B, s, H, D) if transposed else (B, H, s, D)
        t = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        return t.transpose(1, 2) if transposed else t

    q, do = rows(Sq), rows(Sq)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    dlse = (torch.randn((B, H, Sq), generator=gen, device=device)
            if with_dlse else None)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, dlse, causal)
    tag = (f"flash_bwd B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal} "
           f"dlse={with_dlse}" + (" q, do transposed" if transposed else ""))
    if Sk == 0 or Sq == 0:
        zero = got[:1] if Sk == 0 else got[1:]
        if not all(torch.equal(g, torch.zeros_like(g)) for g in zero):
            raise AssertionError(f"{tag}: gradients with nothing to sum over "
                                 "must be exactly 0")
        none = dict(max_abs_err=0.0, rel_l2=0.0, share_of_limit=0.0)
        return (q, k, v, o, lse, do), dict.fromkeys(("dq", "dk", "dv"), none)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, causal)
    checks = {name: _check_close(f"{tag} {name}", out, r)
              for name, out, r in zip(("dq", "dk", "dv"), got, ref)}
    if transposed:
        again = fa.flash_attention_bwd(q.contiguous(), k, v, o, lse,
                                       do.contiguous(), dlse, causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: differs from contiguous q and do")
    return (q, k, v, o, lse, do), checks


def bwd_kernel_rows(gen, device, shape, iters):
    """K2 and K3 at the training shape (causal) and where their tiles end
    (S 127/128/129, Sq 1, Sq 300 over Sk 64, Sk 0, Sq 0), on ragged, cross
    (both causal alignments), head_dim-64 and lse-cotangent cases and with
    q and do passed transposed; two launches on the same inputs must agree
    bit for bit. Each kernel is timed alone by CUDA events, with its
    TFLOP/s, beside the plain backward and, as the library time of each,
    autograd of SDPA timed for its backward alone (it computes dq, dk and
    dv together: no single PyTorch call computes K2 or K3 alone). The rows
    also give the time of ``_delta``, the plain PyTorch pass that every
    backward call makes before the kernels."""
    B, H, S, D = shape
    (q, k, v, o, lse, do), checks = _bwd_case(gen, device, B, H, S, S, D,
                                              True)
    extra = {
        name: _bwd_case(gen, device, *args)[1] for name, args in (
            ("S127", (2, 8, 127, 127, D, True)),
            ("S128", (2, 8, 128, 128, D, True)),
            ("S129", (2, 8, 129, 129, D, True)),
            # with an lse cotangent: without one, the single visible key
            # gives ds = dp - delta = 0 up to rounding, and dq and dk would
            # be held to f32 noise
            ("Sq1 Sk1000 causal", (2, 8, 1, 1000, D, True, True)),
            ("Sq1 Sk1000", (2, 8, 1, 1000, D, False)),
            ("Sq300 Sk64 causal", (2, 8, 300, 64, D, True)),
            ("Sq300 Sk0 causal", (2, 8, 300, 0, D, True)),
            ("Sq0 Sk300 causal", (2, 8, 0, 300, D, True)),
            ("ragged S1000", (2, 8, 1000, 1000, D, True)),
            ("cross Sq300 Sk1000 D64", (2, 8, 300, 1000, 64, False)),
            ("cross causal Sq300 Sk1000", (2, 8, 300, 1000, D, True)),
            ("cross causal Sq1000 Sk300 D64", (2, 8, 1000, 300, 64, True)),
            ("S1000 D64", (2, 8, 1000, 1000, 64, True)),
            ("lse cotangent S1000", (2, 8, 1000, 1000, D, True, True)),
            ("q, do transposed S1000", (2, 8, 1000, 1000, D, True, False,
                                        True)),
        )
    }
    scale = D ** -0.5
    delta = fa._delta(o, do, None).contiguous()
    delta_ms = time_ms(lambda: fa._delta(o, do, None), iters, device)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, None, True), max(1, iters // 3), device)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           is_causal=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), iters, device)
    pairs = B * H * _visible_pairs(S, S, True)
    row_bytes = B * H * S * D * 2  # one (B, H, S, D) bf16 tensor
    reads = 4 * row_bytes + 2 * B * H * S * 4  # q, k, v, do; lse, delta
    shape_tag = f"B{B} H{H} S{S} D{D} causal bf16"
    rows = {}
    for name, fn, flops, nbytes, outs in (
            ("flash_bwd_dq", fa._flash_bwd_dq_cuda, 6 * D * pairs,
             reads + row_bytes, ("dq",)),
            ("flash_bwd_dkv", fa._flash_bwd_dkv_cuda, 8 * D * pairs,
             reads + 2 * row_bytes, ("dk", "dv"))):
        def launch():
            return fn(q, k, v, do, lse, delta, True, scale)

        first, second = launch(), launch()
        if name == "flash_bwd_dq":
            first, second = (first,), (second,)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")
        bms, by = bound_ms(nbytes, flops)
        ms = time_ms(launch, iters, device)
        rows[name] = dict(
            shape=shape_tag, **_worst([checks[n] for n in outs]),
            other_cases={c: _worst([e[n] for n in outs])
                         for c, e in extra.items()},
            deterministic=True, ms=ms, tflops=flops / ms / 1e9,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=sdpa_bwd_ms,
            library="scaled_dot_product_attention backward (dq, dk, dv)",
            delta_ms=delta_ms,
        )
    return rows


def _decode_case(gen, device, B, KV, G, Dh, T, pos, quant):
    """K4 on one case: two launches must be bitwise equal, and the output
    must agree with ``flash_decode_plain``. Returns the inputs and the
    check."""
    q = torch.randn((B, KV, G, Dh), generator=gen,
                    device=device).to(torch.bfloat16)
    kf = torch.randn((B, KV, T, Dh), generator=gen, device=device)
    vf = torch.randn((B, KV, T, Dh), generator=gen, device=device)
    if quant:
        (k, ks), (v, vs) = decode._quantize(kf), decode._quantize(vf)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
    del kf, vf
    pos = torch.tensor(pos, dtype=torch.int32, device=device)
    out = fa.flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    again = fa.flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    tag = (f"flash_decode_{'int8' if quant else 'bf16'} B{B} KV{KV} G{G} "
           f"Dh{Dh} T{T} pos {pos.tolist()}")
    if not torch.equal(out, again):
        raise AssertionError(f"{tag}: two launches on the same inputs differ")
    ref = fa.flash_decode_plain(q, k, v, pos, k_scale=ks, v_scale=vs)
    return (q, k, v, ks, vs, pos), _check_close(tag, out, ref)


def _sdpa_decode(q, k, v, pos):
    """K4's function as one SDPA call under a pinned backend: cuDNN, the
    fastest fused backend that takes a bool mask with ``enable_gqa`` on
    the card (EFFICIENT_ATTENTION does not take ``enable_gqa`` and was
    slower with the G heads as query rows; FLASH takes no mask). The G
    query heads of a KV head are its ``enable_gqa`` group. SDPA reads all
    T keys; K4 reads [0, pos]."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, KV, G, Dh = q.shape
    T = k.shape[2]
    qh = q.reshape(B, KV * G, 1, Dh)
    mask = (torch.arange(T, device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]           # (B, 1, 1, T)

    def call():
        with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, enable_gqa=True)
    return call, ("scaled_dot_product_attention, backend pinned to "
                  "CUDNN_ATTENTION (enable_gqa, bool mask; reads all T "
                  "keys)")


def _cold_ms(fn, iters, device):
    """Mean device time of ``fn`` over ``iters`` launches, each timed alone
    by CUDA events after 128 MB are written, so its inputs start outside
    the 50 MB L2 cache as they do between the layers of a decode step (the
    card idles between the write and the launch while the host queues
    it)."""
    if device.type != "cuda":
        return time_ms(fn, iters, device)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=device)
    fn()
    return sum(_queued_ms(fn, 1, QUEUE_AHEAD_CYCLES, before=flush.zero_)
               for _ in range(iters)) / iters


def decode_kernel_rows(gen, device, shape, iters):
    """K4, bf16 and int8 cache, at the timed row ``shape`` (B, KV, G, Dh,
    T) with ragged positions that include 0 and T - 1, and on the cases
    where its 256-key splits and 64-key tiles end: positions 0, 255, 256,
    257, T - 1 and one past the cache; T = 4100 (a tail tile in a partial
    last split); G 1 and 8; Dh 64; one row of T = 32768. Every case takes
    two launches that must agree bit for bit. Timed by CUDA events: warm
    (the mean of ``iters`` launches queued while the card idles), with L2
    flushed before each launch, and back to back as the host issues them
    (the host's cost included); beside the plain version and (bf16) SDPA
    under a pinned backend on the same inputs."""
    B, KV, G, Dh, T = shape
    rng = np.random.default_rng(SEED)
    pos_np = rng.integers(0, T, B)
    pos_np[0], pos_np[-1] = 0, T - 1  # both ends of the cache
    visible = KV * int((np.minimum(pos_np, T - 1) + 1).sum())
    extra_cases = (
        ("pos 0/255/256/257/T-1/T+5", (6, KV, G, Dh, T,
                                       [0, 255, 256, 257, T - 1, T + 5])),
        ("T4100", (3, KV, G, Dh, 4100, [4099, 4096, 1000])),
        ("G1", (2, KV, 1, Dh, T, [T - 1, 1234])),
        ("G8", (2, KV, 8, Dh, T, [T - 1, 1234])),
        ("Dh64", (2, KV, G, 64, T, [T - 1, 777])),
        ("B1 KV1 T32768", (1, 1, G, Dh, 32768, [32767])),
    )
    rows = {}
    for name, quant in (("flash_decode_bf16", False),
                        ("flash_decode_int8", True)):
        (q, k, v, ks, vs, pos), check = _decode_case(
            gen, device, B, KV, G, Dh, T, pos_np.tolist(), quant)
        extra = {c: _decode_case(gen, device, *args, quant)[1]
                 for c, args in extra_cases}
        per_vec = Dh + 4 if quant else 2 * Dh
        nbytes = 2 * visible * per_vec + 2 * q.numel() * 2 + B * 4
        flops = 4 * G * Dh * visible
        bms, by = bound_ms(nbytes, flops)

        def launch():
            return fa.flash_decode_attention(q, k, v, pos, k_scale=ks,
                                             v_scale=vs)

        library_ms = cold_library_ms = b2b_library_ms = library = None
        if not quant:
            sdpa, library = _sdpa_decode(q, k, v, pos)
            library_ms = time_ms(sdpa, iters, device)
            b2b_library_ms = time_ms(sdpa, iters, device, queue_ahead=False)
            cold_library_ms = _cold_ms(sdpa, iters, device)
        rows[name] = dict(
            shape=(f"B{B} KV{KV} G{G} Dh{Dh} T{T} ragged pos "
                   f"{pos_np.tolist()}"),
            **check, other_cases=extra, deterministic=True,
            grid=[B * KV, fa._decode_splits(T)],
            ms=time_ms(launch, iters, device),
            # host included: the wrapper's checks, workspace and ctypes
            # call, which a decode step that waits on the host pays
            back_to_back_ms=time_ms(launch, iters, device,
                                    queue_ahead=False),
            cold_ms=_cold_ms(launch, iters, device),
            # device time per call of the split and the combine kernel
            profile=device_profile(launch, iters, device, top=2),
            plain_ms=time_ms(lambda: fa.flash_decode_plain(
                q, k, v, pos, k_scale=ks, v_scale=vs),
                max(1, iters // 3), device),
            bound_ms=bms, bound_by=by, library_ms=library_ms,
            back_to_back_library_ms=b2b_library_ms,
            cold_library_ms=cold_library_ms, library=library,
        )
        del q, k, v, ks, vs
    return rows


# the ring fold: rank sp-1's work in ring attention at sp = 4, on one card
FOLD_SP = 4
# The fold against the whole sequence at the KERNEL_* limits but for the
# row term, doubled: besides the roundings of one kernel call, the fold
# rounds each partial's o to bf16 before the f32 merge and each partial's
# cotangent (do times its merge weight) to bf16 before K2 and K3, which
# doubles the bf16 noise a row's sum gathers (on an H100 at 4 x 1024, one
# dk element of 16.7M reached 1.0 of the single limit, ||err||/||ref||
# 0.0033; PERF.md §6)
FOLD_ROW_ATOL = 2 * KERNEL_ROW_ATOL


def _plain_diagonal(q, k, v, scale):
    o, lse = fa.flash_attention_plain(q, k, v, True, scale)
    return o.float(), lse


def _plain_attend_past(o, lse, q, k, v, scale):
    o_b, lse_b = fa.flash_attention_plain(q, k, v, False, scale)
    return ring_attention._merge_partials(o, lse, o_b.float(), lse_b)


def _ring_fold(q, k, v, do, dlse, sp, plain=False):
    """What rank ``sp - 1`` of ring attention computes, on one card: its
    chunk of q against the ``sp`` chunks of k and v, composed from the
    ring's own steps (``_diagonal``: K1 causal on its own chunk;
    ``_attend_past``: K1 non-causal with lse on each earlier chunk, in the
    order the hops bring them, merged by ``_merge_partials``), or from
    their plain twins. Returns the merged ``(o, lse)`` and, through
    autograd of ``<o, do> + <lse, dlse>`` (so K2 and K3 take a non-zero
    lse cotangent), dq of the chunk and dk, dv of the whole sequence."""
    diagonal, past = ((_plain_diagonal, _plain_attend_past) if plain else
                      (ring_attention._diagonal, ring_attention._attend_past))
    scale = q.shape[-1] ** -0.5
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    kc, vc = ks.chunk(sp, dim=2), vs.chunk(sp, dim=2)
    o, lse = diagonal(qs, kc[-1], vc[-1], scale)
    for j in range(sp - 2, -1, -1):
        o, lse = past(o, lse, qs, kc[j], vc[j], scale)
    grads = torch.autograd.grad(
        (o * do.float()).sum() + (lse * dlse).sum(), (qs, ks, vs))
    return o.detach(), lse.detach(), grads


def _whole_causal(q, k, v, do, dlse, rows):
    """K1/K2/K3 causal over the whole sequence, with the cotangents on its
    last ``rows`` query rows only."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o, lse = fa.flash_attention(qs, ks, vs, causal=True, return_lse=True)
    o, lse = o[:, :, -rows:], lse[:, :, -rows:]
    grads = torch.autograd.grad(
        (o.float() * do.float()).sum() + (lse * dlse).sum(), (qs, ks, vs))
    return o.detach(), lse.detach(), grads


def ring_fold_rows(gen, device, shape, plain_seq):
    """The ring's per-step kernels composed over ``FOLD_SP`` chunks of one
    sequence (:func:`_ring_fold`) at ``shape`` = (B, H, S total, D),
    against K1-K3 causal over the whole sequence: o and lse of the last
    chunk, its dq, and dk, dv of every chunk, at the KERNEL_* limits with
    FOLD_ROW_ATOL (lse at LSE_ATOL). At ``plain_seq`` total also against
    the plain fold.
    Its K1-K3 launches are held to FOLD_SP each."""
    t0 = time.perf_counter()
    rows = {}
    for S in (shape[2], plain_seq):
        B, H, _, D = shape
        q, k, v = (torch.randn((B, H, S, D), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        n = S // FOLD_SP
        do = torch.randn((B, H, n, D), generator=gen,
                         device=device).to(torch.bfloat16)
        dlse = torch.randn((B, H, n), generator=gen, device=device)
        fa.reset_launch_counts()
        o, lse, (dq, dk, dv) = _ring_fold(q[:, :, -n:], k, v, do, dlse,
                                          FOLD_SP)
        launches = _launches()
        want = dict.fromkeys(fa.LAUNCHES, 0)
        want.update(flash_fwd=FOLD_SP, flash_bwd_dq=FOLD_SP,
                    flash_bwd_dkv=FOLD_SP)
        if launches != want:
            raise AssertionError(f"ring fold S{S}: launches {launches}, "
                                 f"expected {want}")
        tag = f"ring fold sp{FOLD_SP} B{B} H{H} S{S} D{D}"
        refs = {"whole": _whole_causal(q, k, v, do, dlse, n)}
        if S == plain_seq:
            refs["plain fold"] = _ring_fold(q[:, :, -n:], k, v, do, dlse,
                                            FOLD_SP, plain=True)
        row = dict(launches=launches)
        for name, (o_r, lse_r, (dq_r, dk_r, dv_r)) in refs.items():
            checks = {
                "o": _check_close(f"{tag} o vs {name}", o, o_r,
                                  FOLD_ROW_ATOL),
                "dq": _check_close(f"{tag} dq vs {name}", dq[:, :, -n:],
                                   dq_r[:, :, -n:], FOLD_ROW_ATOL),
                "dk": _check_close(f"{tag} dk vs {name}", dk, dk_r,
                                   FOLD_ROW_ATOL),
                "dv": _check_close(f"{tag} dv vs {name}", dv, dv_r,
                                   FOLD_ROW_ATOL)}
            lse_err = float((lse - lse_r).abs().max())
            if not lse_err <= LSE_ATOL:
                raise AssertionError(f"{tag} lse vs {name}: max err "
                                     f"{lse_err:.4g} > {LSE_ATOL}")
            row[f"vs {name}"] = dict(checks, lse_max_abs_err=lse_err)
        if S == shape[2]:
            # forward and backward of the fold (FOLD_SP launches of each
            # kernel) beside the whole sequence's (one of each) on the
            # same inputs, back to back: what the ring's chunking costs
            # rank sp-1
            row["fold_ms"] = time_ms(lambda: _ring_fold(
                q[:, :, -n:], k, v, do, dlse, FOLD_SP), 3, device,
                queue_ahead=False)
            row["whole_ms"] = time_ms(lambda: _whole_causal(
                q, k, v, do, dlse, n), 3, device, queue_ahead=False)
        rows[f"S{S}"] = row
        del q, k, v, o, lse, dq, dk, dv, refs
    return dict(shape=f"B{shape[0]} H{shape[1]} S{shape[2]} D{shape[3]} "
                f"as {FOLD_SP} chunks of {shape[2] // FOLD_SP}, rank "
                f"{FOLD_SP - 1}'s work", sp=FOLD_SP, **rows,
                seconds=time.perf_counter() - t0)


# the tp fold: one LlamaConfig() layer as TP_FOLD tensor-parallel pieces
TP_FOLD = 4
TP_FOLD_ROWS, TP_FOLD_SEQ = 2, 2048
# ||fold - whole|| / ||whole|| of the layer's contribution (its output
# less its input), of dx less dy and of every weight's grad. The pieces
# round their partial products to bf16 before the f32 sum, where the
# whole layer rounds each product once. On an H100 (700 W) the sound fold
# read at most 0.0077 (the attention norm's grad), and a fold that drops
# one piece (TP_FOLD_CONTROLS) read 0.50 to 0.58 on every one of these;
# the limit sits between (PERF.md §6)
TP_FOLD_REL_TOL = 0.05
TP_FOLD_CONTROLS = ("drop_piece",)


class _FoldF(torch.autograd.Function):
    """*f* of the fold: ``n`` copies of ``x``, their cotangents summed in
    f32 (what ``collectives.to_region``'s all-reduce does)."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return sum(g.float() for g in grads).to(grads[0].dtype), None


class _FoldG(torch.autograd.Function):
    """*g* of the fold: the pieces' partials summed in f32 and cast back
    (``collectives.from_region``), the cotangent to each as it is."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.n = len(parts)
        return sum(p.float() for p in parts).to(parts[0].dtype)

    @staticmethod
    def backward(ctx, g):
        return tuple(g for _ in range(ctx.n))


def _tp_fold_layer(x, layer, c, positions, n, drop=None):
    """One layer computed as ``n`` tp pieces on one card: each piece the
    model's own attention and MLP on its slices of the weights
    (``llama.tp_slices``: its q heads and the KV heads they read, its
    MLP columns and rows), entered through *f* and left through *g* as
    on ``n`` cards. ``drop`` (a control) leaves one piece out of each
    sum."""
    def pieces(h, block):
        parts = []
        for t, ht in enumerate(_FoldF.apply(h, n)):
            sl = llama.tp_slices(c, n, t)
            w = {k: (layer[k].narrow(*sl[k]) if k in sl else layer[k])
                 for k in layer}
            if t != drop:
                parts.append(block(ht, w))
        return _FoldG.apply(*parts)

    x = x + pieces(llama.rms_norm(x, layer["attn_norm"], c.norm_eps),
                   lambda h, w: llama.attention(h, w, c, positions))
    return x + pieces(llama.rms_norm(x, layer["ffn_norm"], c.norm_eps),
                      lambda h, w: llama.mlp(h, w, c))


def tp_fold_rows(gen, device, config, control=None):
    """One ``config`` layer (K1-K3 on the flash path) on TP_FOLD_ROWS x
    TP_FOLD_SEQ tokens, forward and backward, as TP_FOLD tp pieces
    (:func:`_tp_fold_layer`: each piece K1-K3 on its H/TP_FOLD q and
    KV/TP_FOLD KV heads) against the whole layer through the same
    kernels: the layer's contribution, dx less dy and every weight's
    grad within TP_FOLD_REL_TOL, K1-K3 launched TP_FOLD + 1 times each.
    ``control`` "drop_piece" leaves the last piece out; the row then
    reports its readings and raises nothing."""
    t0 = time.perf_counter()
    c = dataclasses.replace(config, n_layers=1, use_flash_attention=True)
    layer = llama.layer_params(llama.init_params(c, gen, device), 0)
    x = torch.randn((TP_FOLD_ROWS, TP_FOLD_SEQ, c.dim), generator=gen,
                    device=device).to(c.dtype)
    dy = torch.randn(x.shape, generator=gen, device=device).to(c.dtype)
    positions = torch.arange(TP_FOLD_SEQ, device=device)[None, :].expand(
        TP_FOLD_ROWS, TP_FOLD_SEQ)
    names = sorted(layer)
    drop = TP_FOLD - 1 if control == "drop_piece" else None
    if control not in (None, *TP_FOLD_CONTROLS):
        raise ValueError(f"unknown tp fold control {control!r}")

    def run(fold):
        xs = x.detach().requires_grad_()
        ws = {k: layer[k].detach().requires_grad_() for k in names}
        y = (_tp_fold_layer(xs, ws, c, positions, TP_FOLD, drop) if fold
             else llama._layer(xs, ws, c, positions))
        grads = torch.autograd.grad(y, [xs, *(ws[k] for k in names)], dy)
        return y.detach(), grads

    fa.reset_launch_counts()
    y_f, g_f = run(True)
    y_w, g_w = run(False)
    launches = _launches()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    k = TP_FOLD + (0 if drop is None else -1) + 1
    want.update(flash_fwd=k, flash_bwd_dq=k, flash_bwd_dkv=k)

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.float() - b.float())
                     / torch.linalg.vector_norm(b.float()))

    readings = {"out": rel(y_f - x, y_w - x), "dx": rel(g_f[0] - dy,
                                                        g_w[0] - dy)}
    for name, gf, gw in zip(names, g_f[1:], g_w[1:]):
        readings[f"d{name}"] = rel(gf, gw)
    worst = max(readings, key=readings.get)
    row = dict(
        shape=f"1 layer, B{TP_FOLD_ROWS} S{TP_FOLD_SEQ}, dim {c.dim}, "
              f"{c.n_heads} q / {c.n_kv_heads} KV heads as {TP_FOLD} "
              f"pieces of {c.n_heads // TP_FOLD} / "
              f"{max(1, c.n_kv_heads // TP_FOLD)}",
        control=control, rel=readings, worst=worst,
        worst_rel=readings[worst], limit=TP_FOLD_REL_TOL,
        share_of_limit=readings[worst] / TP_FOLD_REL_TOL,
        launches=launches)
    if control is None:
        row["fold_ms"] = time_ms(lambda: run(True), 3, device,
                                 queue_ahead=False)
        row["whole_ms"] = time_ms(lambda: run(False), 3, device,
                                  queue_ahead=False)
    row["seconds"] = time.perf_counter() - t0
    if control is None:
        if launches != want:
            raise AssertionError(f"tp fold: launches {launches}, expected "
                                 f"{want}")
        if not readings[worst] <= TP_FOLD_REL_TOL:
            raise AssertionError(f"tp fold: {worst} {readings[worst]:.4g} "
                                 f"> {TP_FOLD_REL_TOL}: {row}")
    return row


def kernel_phase(device, fwd_shape, bwd_shape, decode_shape, iters=10,
                 fwd_timed=(), fold_shape=None, fold_plain_seq=4096,
                 tp_fold_config=None):
    """Hold every kernel against its plain version; returns the JSON rows
    of the kernel table (without launches). K1 is timed at ``fwd_shape``
    and at each causal ``(B, H, S)`` of ``fwd_timed`` (same head_dim)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    B, H, S, D = fwd_shape
    cases = {}
    (q, k, v), check = _fwd_case(gen, device, B, H, S, S, D, True)
    # edges of the 128 x 128 tiles, ragged and cross shapes (both causal
    # alignments), head_dim 64, and q as the models pass it
    extra = {
        name: _fwd_case(gen, device, *args)[1] for name, args in (
            ("S127", (2, 8, 127, 127, D, True)),
            ("S128", (2, 8, 128, 128, D, True)),
            ("S129", (2, 8, 129, 129, D, True)),
            ("Sq1 Sk1000 causal", (2, 8, 1, 1000, D, True)),
            ("Sq1 Sk1000", (2, 8, 1, 1000, D, False)),
            ("Sq300 Sk64 causal", (2, 8, 300, 64, D, True)),
            ("Sq300 Sk0 causal", (2, 8, 300, 0, D, True)),
            ("ragged S1000", (2, 8, 1000, 1000, D, True)),
            ("cross Sq300 Sk1000 D64", (2, 8, 300, 1000, 64, False)),
            ("cross causal Sq1000 Sk300 D64", (2, 8, 1000, 300, 64, True)),
            ("S1000 D64", (2, 8, 1000, 1000, 64, True)),
            ("q transposed S1000", (2, 8, 1000, 1000, D, True, True)),
        )
    }
    timings = {}
    for tb, th, ts in dict.fromkeys([(B, H, S), *fwd_timed]):
        if (tb, th, ts) == (B, H, S):
            tq, tk, tv = q, k, v
        else:
            tq, tk, tv = (torch.randn((tb, th, ts, D), generator=gen,
                                      device=device).to(torch.bfloat16)
                          for _ in range(3))
        flops = 4 * D * tb * th * _visible_pairs(ts, ts, True)
        bms, by = bound_ms(4 * tb * th * ts * D * 2 + tb * th * ts * 4, flops)
        ms = time_ms(lambda: fa.flash_attention(tq, tk, tv, causal=True),
                     iters, device)
        timings[f"B{tb} H{th} S{ts}"] = dict(
            ms=ms, tflops=flops / ms / 1e9, bound_ms=bms, bound_by=by,
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    tq, tk, tv, is_causal=True), iters, device))
        del tq, tk, tv
    main = timings[f"B{B} H{H} S{S}"]
    cases["flash_fwd"] = dict(
        shape=f"B{B} H{H} S{S} D{D} causal bf16", **check,
        other_cases=extra, ms=main["ms"], tflops=main["tflops"],
        plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                         max(1, iters // 3), device),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"],
        library="scaled_dot_product_attention (causal)",
        timings=timings,
    )
    del q, k, v
    cases.update(bwd_kernel_rows(gen, device, bwd_shape, iters))

    cases.update(decode_kernel_rows(gen, device, decode_shape, iters))
    if fold_shape is not None:
        cases["ring_fold"] = ring_fold_rows(gen, device, fold_shape,
                                            fold_plain_seq)
    if tp_fold_config is not None:
        cases["tp_fold"] = tp_fold_rows(gen, device, tp_fold_config)
    emit({"phase": "kernels", **cases})
    return cases


# ---------------------------------------------------------------------------
# the timer phase: the device timer's CUDA hook on the card
# ---------------------------------------------------------------------------

# the train step's MLP GEMM: 8 x 2048 tokens by dim 4096 into ffn 11008
TIMER_GEMM = (16384, 4096, 11008)
TIMER_GEMMS = 20
# the hang watchdog's timeout in the timer child; its wedge spins twice it
TIMER_HANG_TIMEOUT_S = 3.0
# the hook's GEMM latency and FLOPS against CUDA events taken by torch:
# its mean against torch's pair around the loop (which holds the launch
# gaps, microseconds against ~2 ms GEMMs), the FLOPS gauge (the rate of
# the kernel's last record) against torch's pair around the last GEMM. A
# GEMM's time varies by up to 7% within the loop on the card, so the
# gauge is not held against the loop's mean
TIMER_MATCH_REL = 0.05
# one watchdog tick (200 ms), a poll of the hook (5 ms) and this child's
# polling of the gauge (10 ms), with room
TIMER_RISE_SLACK_S = 0.5
# replayed against recorded GEMM rate on a healthy card
TIMER_REPLAY_MIN = 0.8
TIMER_COPY_BYTES = 1 << 30
TIMER_ALLREDUCE_BYTES = 256 << 20


def _shape_events(timer, dims):
    """The hooked GEMM events of the trace ring whose m, n, k are ``dims``
    in any order (cuBLAS's m x n is torch's product transposed)."""
    want = sorted(dims)
    return [e for e in json.loads(timer.trace_json())["traceEvents"]
            if e["cat"] == "mm" and sorted(
                [e["args"].get("m"), e["args"].get("n"), e["args"].get("k")]
                if "m" in e["args"] else []) == want]


def _gauge(text, family, kernel=None):
    for line in text.splitlines():
        if line.startswith(family + "{") and (
                kernel is None or f'kernel="{kernel}"' in line):
            return float(line.rsplit(" ", 1)[1])
    return None


def timer_child(args) -> int:
    """``--timer-child``: runs under ``LD_PRELOAD`` with the port's hook
    library (see :func:`timer_phase`); prints one ``TIMER {...}`` line."""
    import threading
    import urllib.request

    import torch.distributed as dist

    from dlrover_tpu_torch.common.multi_process import LocalIPCServer
    from dlrover_tpu_torch.common.rpc import find_free_port
    from dlrover_tpu_torch.observability import profiler
    from dlrover_tpu_torch.observability.replay import replay
    from dlrover_tpu_torch.observability.timeline import start_daemon
    from dlrover_tpu_torch.observability.tpu_timer import TpuTimer

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    timer = TpuTimer()
    timer.install(0, 1, 0, port=args["port"], device=device,
                  hang_timeout_s=args["hang_timeout_s"])
    gen = torch.Generator(device=device).manual_seed(SEED)
    M, K, N = TIMER_GEMM
    a = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn(K, N, generator=gen, device=device).to(torch.bfloat16)

    # 1. 20 bf16 GEMMs at the MLP shape, against torch's events
    torch.matmul(a, b)
    torch.cuda.synchronize()
    timer.wait_drained()
    before = len(_shape_events(timer, TIMER_GEMM))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(TIMER_GEMMS)]
    start.record()
    for first, last in pairs:
        first.record()
        torch.matmul(a, b)
        last.record()
    end.record()
    end.synchronize()
    timer.wait_drained()
    evs = _shape_events(timer, TIMER_GEMM)
    new = evs[before:]
    torch_ms = start.elapsed_time(end) / TIMER_GEMMS
    torch_each_ms = [first.elapsed_time(last) for first, last in pairs]
    flops = 2.0 * M * N * K
    text = timer.prometheus_text()
    name = new[-1]["name"] if new else None
    out["gemm"] = dict(
        name=name, count=len(new), dims=[new[-1]["args"][k] for k in
                                         ("m", "n", "k", "batch")]
        if new else None,
        hook_mean_ms=(sum(e["dur"] for e in new) / len(new) / 1e3
                      if new else None),
        torch_ms=torch_ms,
        hook_each_ms=[e["dur"] / 1e3 for e in new],
        torch_each_ms=torch_each_ms,
        # the gauge is the rate of the kernel's last record, so it is held
        # against torch's events around that same GEMM
        hook_flops=_gauge(text, "XPU_TIMER_MM_KERNEL_FLOPS", name),
        torch_flops=flops / (torch_each_ms[-1] / 1e3))

    # 2. a 1 GiB pinned D2H and H2D copy
    host = torch.empty(TIMER_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(TIMER_COPY_BYTES, dtype=torch.uint8, device=device)
    host.copy_(dev, non_blocking=True)
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    timer.wait_drained()
    copies = {}
    for e in json.loads(timer.trace_json())["traceEvents"]:
        if e["cat"] == "memory" and e["args"]["bytes"] == TIMER_COPY_BYTES:
            copies.setdefault(e["name"], []).append(
                dict(bytes=e["args"]["bytes"], us=e["dur"],
                     gb_per_s=e["args"]["bytes"] / max(e["dur"], 1) / 1e3))
    out["copies"] = copies
    del host, dev

    # 3. a one-rank NCCL all_reduce of 256 MiB
    port = find_free_port("127.0.0.1")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, device_id=device)
    coll_before = _gauge(timer.prometheus_text(),
                         "XPU_TIMER_COLL_KERNEL_COUNT", "ncclAllReduce") or 0
    t = torch.ones(TIMER_ALLREDUCE_BYTES // 4, device=device)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    timer.wait_drained()
    text = timer.prometheus_text()
    reduces = [e for e in json.loads(timer.trace_json())["traceEvents"]
               if e["name"] == "ncclAllReduce"]
    out["allreduce"] = dict(
        count=(_gauge(text, "XPU_TIMER_COLL_KERNEL_COUNT", "ncclAllReduce")
               or 0) - coll_before,
        bytes=reduces[-1]["args"]["payload"] if reduces else None,
        us=reduces[-1]["dur"] if reduces else None,
        bandwidth=_gauge(text, "XPU_TIMER_COLL_KERNEL_BANDWIDTH",
                         "ncclAllReduce"))
    dist.destroy_process_group()
    del t

    # 5. a GEMM inside CUDA graph capture: no fault, no record
    small = torch.randn(512, 512, generator=gen,
                        device=device).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.matmul(small, small)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    timer.wait_drained()
    cap_before = len(_shape_events(timer, (512, 512, 512)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = torch.matmul(small, small)
    graph.replay()
    torch.cuda.synchronize()
    timer.wait_drained()
    out["capture"] = dict(
        recorded=len(_shape_events(timer, (512, 512, 512))) - cap_before,
        replayed_ok=bool(torch.allclose(
            captured.float(), (small.float() @ small.float()),
            rtol=2e-2, atol=2e-1)))
    del graph, captured

    # 4. a wedge: the card spins for twice the hang timeout, a GEMM behind
    cal0 = torch.cuda.Event(enable_timing=True)
    cal1 = torch.cuda.Event(enable_timing=True)
    cal0.record()
    torch.cuda._sleep(100_000_000)
    cal1.record()
    cal1.synchronize()
    cycles_per_ms = 100_000_000 / cal0.elapsed_time(cal1)
    timeout_s = args["hang_timeout_s"]
    hang_path = f"/tmp/tpu_timer_hang_{os.getpid()}.txt"
    stack_path = f"/tmp/tpu_timer_pystack_{os.getpid()}.txt"
    wedge_gemm = torch.randn(1024, 1024, generator=gen,
                             device=device).to(torch.bfloat16)
    # its kernel loaded first: a first call would load it inside cuBLAS,
    # and the load waits for the spin (the hook sees that call as pending
    # too, but this thread could not poll until it returned)
    torch.matmul(wedge_gemm, wedge_gemm)
    torch.cuda.synchronize()
    timer.wait_drained()
    torch.cuda._sleep(int(2 * timeout_s * 1e3 * cycles_per_ms))
    t0 = time.monotonic()
    t0_wall = time.time()
    torch.matmul(wedge_gemm, wedge_gemm)
    rise = None
    while time.monotonic() - t0 < 2 * timeout_s + 5:
        if timer.hang_detected():
            rise = time.monotonic() - t0
            break
        time.sleep(0.01)
    time.sleep(0.3)
    hang_gauge = _gauge(timer.prometheus_text(), "XPU_TIMER_COMMON_HANG")
    hang_file = open(hang_path).read() if os.path.exists(hang_path) else ""
    # the watchdog writes the file in the tick it raises the gauge
    file_rise = (os.stat(hang_path).st_mtime - t0_wall
                 if os.path.exists(hang_path) else None)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    cleared = None
    while time.monotonic() - t1 < 3:
        if not timer.hang_detected():
            cleared = time.monotonic() - t1
            break
        time.sleep(0.01)
    time.sleep(0.3)
    stacks = open(stack_path).read() if os.path.exists(stack_path) else ""
    out["hang"] = dict(
        timeout_s=timeout_s, rise_s=rise, file_rise_s=file_rise,
        gauge=hang_gauge, cleared_s=cleared,
        gauge_after=_gauge(timer.prometheus_text(), "XPU_TIMER_COMMON_HANG"),
        hang_file=hang_file.strip(),
        stack_names_main="timer_child" in stacks,
        stack_bytes=len(stacks))
    for path in (hang_path,):
        if os.path.exists(path):
            os.remove(path)

    # 7. the daemon over this worker
    listen = find_free_port("127.0.0.1")
    daemon = start_daemon(listen_port=listen, base_port=args["port"],
                          n_workers=1)
    try:
        body = trace = None
        for _ in range(100):
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{listen}/metrics",
                    timeout=10).read().decode()
                trace = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{listen}/dump_trace?name={name}",
                    timeout=10).read().decode())
                break
            except OSError:
                time.sleep(0.05)
        out["daemon"] = dict(
            families=sorted({ln.split("{")[0] for ln in
                             (body or "").splitlines()}),
            gemm_count=_gauge(body or "", "XPU_TIMER_MM_KERNEL_COUNT", name),
            dump_trace_events=len((trace or {}).get("traceEvents", [])))

        # 8. replay of the trace's top 3 GEMMs, through the daemon
        t_replay = time.perf_counter()
        report = replay(f"http://127.0.0.1:{listen}/dump_trace", top_k=3,
                        device=device)
        out["replay"] = dict(seconds=time.perf_counter() - t_replay,
                             kernels=report["kernels"])
    finally:
        daemon.kill()
        daemon.wait()

    # 9. a profile requested over the agent's IPC plane
    sock = f"/tmp/dtpu_timer_{os.getpid()}.sock"
    ipc = LocalIPCServer(sock)
    ipc.start()
    try:
        listener = profiler.ProfileListener(sock, 0, poll_s=0.1)
        listener.start()
        pdict = ipc.local_dict(profiler.PROFILE_DICT)
        t_prof = time.perf_counter()
        req = profiler.request_profile(pdict, 0, duration_s=1.0)
        done = None
        while done is None and time.perf_counter() - t_prof < 60:
            for _ in range(10):
                torch.matmul(a, b)
            torch.cuda.synchronize()
            got = pdict.get(profiler.done_key(0))
            done = got if got and got.get("id") == req else None
        listener.stop()
        kernels = cpu_main = cpu_ops = 0
        if done and done.get("ok"):
            with open(done["path"]) as f:
                events = json.load(f)["traceEvents"]
            main_tid = threading.get_native_id()
            for e in events:
                if e.get("cat") == "kernel":
                    kernels += 1
                elif e.get("cat") == "cpu_op":
                    cpu_ops += 1
                    cpu_main += e.get("tid") == main_tid
            shutil.rmtree(done["dir"], ignore_errors=True)
        out["profile"] = dict(ok=bool(done and done.get("ok")),
                              seconds=time.perf_counter() - t_prof,
                              kernel_events=kernels, cpu_op_events=cpu_ops,
                              cpu_op_events_main_thread=cpu_main)
    finally:
        ipc.stop()

    # 6. the host's cost per hooked call: 1000 small GEMMs, hook on and off
    tiny = torch.randn(64, 64, generator=gen,
                       device=device).to(torch.bfloat16)

    def host_us(on):
        timer.set_hook_enabled(on)
        torch.matmul(tiny, tiny)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(1000):
            torch.matmul(tiny, tiny)
        took = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        timer.wait_drained()
        return took

    runs = [host_us(False), host_us(True), host_us(True), host_us(False)]
    timer.set_hook_enabled(True)
    out["host_cost"] = dict(
        us_per_call_off=(runs[0] + runs[3]) / 2,
        us_per_call_on=(runs[1] + runs[2]) / 2,
        hook_us_per_call=(runs[1] + runs[2] - runs[0] - runs[3]) / 2,
        runs_us_per_call=runs)
    if os.path.exists(stack_path):
        os.remove(stack_path)
    print("TIMER " + json.dumps(out), flush=True)
    return 0


def timer_phase(device):
    """Build the device timer, then drive its hook on the card in a child
    under ``LD_PRELOAD`` (module docstring, phase ``timer``). Returns the
    phase's row."""
    from dlrover_tpu_torch.common.rpc import find_free_port
    from dlrover_tpu_torch.tpu_timer import build as timer_build

    t0 = time.perf_counter()
    paths = timer_build.build()
    build_s = time.perf_counter() - t0
    port = find_free_port("127.0.0.1")
    env = dict(os.environ, PYTHONPATH=REPO, LD_PRELOAD=str(paths["lib"]),
               TPU_TIMER_LIB=str(paths["lib"]))
    args = dict(port=port, hang_timeout_s=TIMER_HANG_TIMEOUT_S)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--timer-child",
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=600, cwd=REPO)
    child_s = time.perf_counter() - t1
    got = _lines(proc.stdout, "TIMER")
    if proc.returncode != 0 or not got:
        raise AssertionError(f"timer: the child exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    r = got[0]
    g, h = r["gemm"], r["hang"]
    problems = []
    if g["count"] != TIMER_GEMMS or not g["dims"] or sorted(
            g["dims"][:3]) != sorted(TIMER_GEMM) or g["dims"][3] != 1:
        problems.append(f"GEMMs recorded {g['count']} at {g['dims']}")
    elif not (abs(g["hook_mean_ms"] / g["torch_ms"] - 1) <= TIMER_MATCH_REL
              and abs(g["hook_flops"] / g["torch_flops"] - 1)
              <= TIMER_MATCH_REL):
        problems.append(f"GEMM latency/FLOPS off torch's events: {g}")
    for kind in ("memcpy_d2h", "memcpy_h2d"):
        if len(r["copies"].get(kind, [])) != 1:
            problems.append(f"{kind}: {r['copies'].get(kind)}")
    ar = r["allreduce"]
    if ar["count"] != 1 or ar["bytes"] != TIMER_ALLREDUCE_BYTES or not (
            ar["bandwidth"] and ar["bandwidth"] > 0):
        problems.append(f"all_reduce: {ar}")
    if not (h["rise_s"] is not None and h["timeout_s"] <= h["rise_s"]
            <= h["timeout_s"] + TIMER_RISE_SLACK_S and h["gauge"] == 1):
        problems.append(f"hang gauge: {h}")
    if "cublas" not in h["hang_file"] or "stream" not in h["hang_file"]:
        problems.append(f"hang file: {h['hang_file']!r}")
    if not h["stack_names_main"]:
        problems.append("the faulthandler dump lacks the main thread")
    if h["cleared_s"] is None or h["gauge_after"] != 0:
        problems.append(f"the hang gauge did not clear: {h}")
    if r["capture"] != {"recorded": 0, "replayed_ok": True}:
        problems.append(f"capture: {r['capture']}")
    d = r["daemon"]
    if (d["gemm_count"] or 0) < TIMER_GEMMS or d["dump_trace_events"] < \
            TIMER_GEMMS or "XPU_TIMER_COMMON_HANG" not in d["families"]:
        problems.append(f"daemon: {d}")
    ks = r["replay"]["kernels"]
    if len(ks) != 3 or any((k["ratio"] or 0) < TIMER_REPLAY_MIN
                           for k in ks):
        problems.append(f"replay: {ks}")
    if not r["profile"]["ok"] or r["profile"]["kernel_events"] <= 0:
        problems.append(f"profile: {r['profile']}")
    row = dict(phase="timer", build_s=build_s, child_s=child_s,
               library=paths["lib"].name, card=_card(), **r)
    emit(row)
    if problems:
        raise AssertionError("timer: " + "; ".join(problems))
    return row


# ---------------------------------------------------------------------------
# the memory ledger and the compile watch (phases 2-5, 7)
# ---------------------------------------------------------------------------


def fresh_ledger():
    """A fresh process memory accountant and compile watch on their own
    registry and journal, so a phase reads its own claims, signatures and
    storms: ``(accountant, watcher, journal, registry)``."""
    from dlrover_tpu_torch.observability import compile_watch, memory
    from dlrover_tpu_torch.observability.journal import EventJournal
    from dlrover_tpu_torch.observability.registry import MetricsRegistry

    registry = MetricsRegistry()
    journal = EventJournal()
    acct = memory.set_accountant(memory.MemoryAccountant(
        journal=journal, registry=registry, source="chip_smoke"))
    watcher = compile_watch.set_watcher(compile_watch.CompileWatcher(
        journal=journal, registry=registry, source="chip_smoke"))
    return acct, watcher, journal, registry


def ledger_claims(acct, category):
    """``{buffer name: bytes}`` the accountant holds under ``category``."""
    with acct._lock:
        return dict(acct._ledger[category])


def ledger_row(acct, device):
    """One sweep of the accountant against the card: the ledger, the
    allocator's allocated bytes it reconciles against (and the reserved
    bytes beside them), the unattributed bytes and the headroom, and the
    ledger's peak watermark beside ``torch.cuda.max_memory_allocated``."""
    rec = acct.reconcile()
    snap = acct.snapshot()
    row = dict(categories={c: b for c, b in snap["categories"].items() if b},
               ledger_bytes=rec["ledger_bytes"],
               device_allocated_bytes=rec["device_used"],
               limit_bytes=rec["limit_bytes"],
               unattributed_bytes=rec["unattributed_bytes"],
               headroom_bytes=rec["headroom_bytes"],
               headroom_frac=rec["headroom_frac"],
               peak_watermark_bytes=snap["peak_total_bytes"])
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        row.update(device_reserved_bytes=stats["reserved_bytes.all.current"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(
                       device))
        if rec["degraded"] or rec["limit_bytes"] <= 0:
            raise AssertionError(f"ledger: the sweep did not read the card: "
                                 f"{rec}")
    return row


def compile_row(watcher, journal, registry, shapes, what,
                churning=()):
    """The compile watch against an engine's distinct shape keys: per
    function, ``dlrover_compile_total{fn}`` equals the keys of its kind;
    the seconds of each miss; no storm journaled, except on a function of
    ``churning`` (its signature varies by design), where a storm must be
    attributed to ``seq_len``."""
    kinds = sorted({k[0] for k in shapes})
    counts = {}
    text = registry.render()
    for kind in kinds:
        fn = f"engine.{kind}"
        want = sum(1 for k in shapes if k[0] == kind)
        line = f'dlrover_compile_total{{fn="{fn}"}} {want}'
        counts[fn] = watcher.compile_count(fn)
        if counts[fn] != want or line not in text.splitlines():
            raise AssertionError(f"{what}: compile watch counts {counts} vs "
                                 f"the engine's keys {sorted(shapes)}")
    storms = [e["data"] for e in journal.events()
              if e["kind"] == "recompile_storm"]
    if any(st["fn"] not in churning or st["dim"] != "seq_len"
           for st in storms):
        raise AssertionError(f"{what}: steady traffic journaled a storm: "
                             f"{storms}")
    return dict(compile_total=counts, storms=storms, misses=[
        dict(fn=m["fn"], dims=m["dims"], seconds=m["seconds"])
        for m in watcher.misses()])


# ---------------------------------------------------------------------------
# phase 2: generate at full width
# ---------------------------------------------------------------------------


def _launches():
    return dict(fa.LAUNCHES)


@contextlib.contextmanager
def record_routes(config):
    """Collect each ``moe._route`` (and, under sequence parallelism,
    ``moe._route_sp``) call's decisions while inside, for a MoE ``config``
    (an empty list for any other): a list of ``(expert (G, g, k) int,
    kept (G, g, k) bool)`` pairs (``(B, s, k)``, the rank's chunk, for
    ``_route_sp``), detached, in call order, for comparing two routes of
    the same inputs. The model's functions are wrapped for the duration
    and restored after."""
    routes = []
    if not isinstance(config, moe.MoEConfig):
        yield routes
        return
    reals = {name: getattr(moe, name) for name in ("_route", "_route_sp")}

    def recording(real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            routes.append((out[0].detach(), out[2].detach()))
            return out
        return call

    for name, real in reals.items():
        setattr(moe, name, recording(real))
    try:
        yield routes
    finally:
        for name, real in reals.items():
            setattr(moe, name, real)


def route_flips(a, b):
    """(decisions that differ, decisions) between two
    :func:`record_routes` lists of the same calls: a choice whose expert
    or whose kept flag differs."""
    flips = total = 0
    for (ea, ka), (eb, kb) in zip(a, b):
        flips += int(((ea != eb) | (ka != kb)).sum())
        total += ea.numel()
    return flips, total


def _rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def generate_phase(params, config, device, tag, batch, prompt_len, new,
                   quantize, max_len, timed_steps):
    gen = torch.Generator(device=device).manual_seed(SEED + prompt_len)
    prompt = torch.randint(0, config.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    total = prompt_len + new
    T, flash = decode.planned_cache_len(total, quantize, max_len,
                                        device=device)
    L = config.n_layers
    acct = fresh_ledger()[0]

    # the main path: one generate call, counted
    fa.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    out = decode.generate(params, prompt, config, None, new,
                          temperature=0.0, max_len=max_len,
                          quantize_cache=quantize)
    _sync(device)
    generate_s = time.perf_counter() - t0
    counts = _launches()
    k4 = "flash_decode_int8" if quantize else "flash_decode_bf16"
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = L if prompt_len >= 256 else 0
    if flash:
        want[k4] = L * (new - 1)
    if counts != want:
        raise AssertionError(f"generate {tag}: launches {counts}, "
                             f"expected {want}")
    if (tuple(out.shape) != (batch, total)
            or not torch.equal(out[:, :prompt_len].long(), prompt)
            or int(out.min()) < 0 or int(out.max()) >= config.vocab_size):
        raise AssertionError(f"generate {tag}: malformed output")

    # TTFT and decode rate, and the kernel path against the dense path
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = decode.prefill(params, prompt, config, T, quantize)
    _sync(device)
    ttft_s = time.perf_counter() - t0
    dense_cfg = dataclasses.replace(config, use_flash_attention=False)
    os.environ["DLROVER_TPU_FLASH_DECODE"] = "0"
    try:
        ref_logits, ref_cache = decode.prefill(params, prompt, dense_cfg, T,
                                               quantize)
        tok = torch.argmax(logits, dim=-1)
        ref_step, _ = decode.decode_step(params, tok, ref_cache, dense_cfg)
    finally:
        del os.environ["DLROVER_TPU_FLASH_DECODE"]
    del ref_cache
    step_logits, cache = decode.decode_step(params, tok, cache, config,
                                            flash=flash)
    prefill_err = _rel_err(logits, ref_logits)
    step_err = _rel_err(step_logits, ref_step)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits)
            .all()) or max(prefill_err, step_err) > LOGITS_REL_TOL:
        raise AssertionError(
            f"generate {tag}: kernel vs dense logits rel err prefill "
            f"{prefill_err:.4g}, step {step_err:.4g} > {LOGITS_REL_TOL}")
    state = {"tok": torch.argmax(step_logits, dim=-1), "cache": cache}

    def step():
        lg, state["cache"] = decode.decode_step(params, state["tok"],
                                                state["cache"], config,
                                                flash=flash)
        state["tok"] = torch.argmax(lg, dim=-1)

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        step()
    _sync(device)
    decode_s = time.perf_counter() - t0
    # where the time goes: device kernels vs the rest (host)
    profile = device_profile(step, 4, device, match="flash_decode")
    prefill_profile = device_profile(
        lambda: decode.prefill(params, prompt, config, T, quantize), 1,
        device)
    row = dict(
        phase="generate", run=tag, batch=batch, prompt_len=prompt_len,
        new_tokens=new, cache=("int8" if quantize else "bf16"),
        cache_len=T, decode_kernel=flash, generate_s=generate_s,
        ttft_s=ttft_s, decode_tok_per_s=batch * timed_steps / decode_s,
        decode_step_ms=decode_s * 1e3 / timed_steps, launches=counts,
        logits_rel_err_prefill=prefill_err, logits_rel_err_step=step_err,
        decode_step_profile=profile, prefill_profile=prefill_profile,
        # decode.generate owns no ledger claim: its weights and cache are
        # the unattributed bytes
        memory=ledger_row(acct, device),
    )
    emit(row)
    return counts


# ---------------------------------------------------------------------------
# phase 3: the batched engine on ragged slots
# ---------------------------------------------------------------------------


def _bucket(n):
    b = 128
    while b < n:
        b *= 2
    return b


def _teacher_agreement(params, config, device, pairs):
    """The share of generated tokens that a dense forward over prompt +
    generated tokens reproduces (bf16; see TEACHER_AGREE_MIN), over
    ``pairs`` of (prompt, generated tokens)."""
    dense_cfg = dataclasses.replace(config, use_flash_attention=False)
    agree = total = 0
    for prompt, gen in pairs:
        seq = torch.tensor([list(prompt) + list(gen[:-1])], device=device)
        with torch.no_grad():
            logits = llama.forward(params, seq, dense_cfg)[0]
        pred = torch.argmax(logits[len(prompt) - 1:], dim=-1).tolist()
        agree += sum(int(a == b) for a, b in zip(pred, gen))
        total += len(gen)
        del logits
    return agree / total


def _moe_engine_teacher(params, config, device, cache_len, pairs):
    """The MoE engine's teacher: a one-slot engine on the plain route
    (bf16 cache, dense attend), teacher-forced on each of ``pairs``
    (prompt, generated tokens). It routes as the engine does (the
    bucket-padded prompt one group, each step's token alone), where a
    single forward over the sequence would route it as one group and drop
    other choices. Returns the share of tokens it reproduces and, per
    pair, the routes of its steps (``record_routes`` lists)."""
    os.environ["DLROVER_TPU_FLASH_DECODE"] = "0"
    try:
        teacher = BatchDecodeEngine(params, config, slots=1,
                                    cache_len=cache_len, device=device)
        agree = total = 0
        step_routes = []
        for prompt, gen in pairs:
            pred = [teacher.insert(teacher.prefill_rows(
                prompt, _bucket(len(prompt))), 0)]
            with record_routes(config) as routes:
                for t in gen[:-1]:
                    pred.append(teacher.step([t], [True])[0])
            agree += sum(int(a == b) for a, b in zip(pred, gen))
            total += len(gen)
            step_routes.append(routes)
    finally:
        del os.environ["DLROVER_TPU_FLASH_DECODE"]
    return agree / total, step_routes


def _engine_step_flips(routes, marks, teacher_routes, L):
    """(decisions that differ, decisions) between the engine's steps and
    the teacher's, token by token: ``marks`` holds, for each of a
    request's steps, the index of the step's first layer in ``routes`` and
    the request's slot there."""
    flips = total = 0
    for req_marks, t_routes in zip(marks, teacher_routes):
        for j, (first, slot) in enumerate(req_marks):
            for li in range(L):
                ek, kk = routes[first + li]
                et, kt = t_routes[j * L + li]
                flips += int(((ek[slot] != et[0]) | (kk[slot] != kt[0]))
                             .sum())
                total += et[0].numel()
    return flips, total


def engine_phase(params, config, device, slots, cache_len, n_requests,
                 len_range, new_range, n_teacher, phase="engine"):
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(n_requests):
        n = int(rng.integers(len_range[0], len_range[1] + 1))
        reqs.append((rng.integers(1, config.vocab_size, n).tolist(),
                     int(rng.integers(new_range[0], new_range[1] + 1))))
    acct, watcher, journal, registry = fresh_ledger()
    engine = BatchDecodeEngine(params, config, slots=slots,
                               cache_len=cache_len, quantize=True,
                               device=device)
    # the engine's claim: exactly its cache tensors' bytes
    exact = sum(t.numel() * t.element_size()
                for bufs in (engine._k, engine._v, engine._ks, engine._vs)
                for t in bufs)
    claims = ledger_claims(acct, "kv_cache")
    if claims != {f"engine/{id(engine):x}/kv": exact}:
        raise AssertionError(f"engine: kv_cache claims {claims}, its "
                             f"cache holds {exact} bytes")
    flash = decode.flash_decode_wanted(cache_len, True, device=device)
    L = config.n_layers

    fa.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    with record_routes(config) as routes:
        active = [None] * slots  # slot -> [request index, position, tokens]
        done = {}
        # per request, its steps' (first route of the step, slot)
        marks = [[] for _ in range(n_requests)]
        pending = list(range(n_requests))
        steps = ragged_steps = 0
        while pending or any(a is not None for a in active):
            for s in range(slots):
                if active[s] is None and pending:
                    r = pending.pop(0)
                    prompt = reqs[r][0]
                    res = engine.prefill_rows(prompt, _bucket(len(prompt)))
                    active[s] = [r, len(prompt), [engine.insert(res, s)]]
            live = [a is not None for a in active]
            if len({a[1] for a in active if a is not None}) > 1:
                ragged_steps += 1
            first_route = len(routes)
            nxt = engine.step([a[2][-1] if a else 0 for a in active], live)
            steps += 1
            for s, a in enumerate(active):
                if a is None:
                    continue
                marks[a[0]].append((first_route, s))
                a[1] += 1
                a[2].append(nxt[s])
                if len(a[2]) == reqs[a[0]][1]:
                    done[a[0]] = a[2]
                    active[s] = None
        _sync(device)
        serve_s = time.perf_counter() - t0
    # MoE: the choices the prefills dropped at capacity (the steps drop
    # none)
    route_drops = sum(int((~kept).sum()) for _, kept in routes)
    counts = _launches()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_decode_int8"] = L * steps if flash else 0
    if counts != want or not flash or ragged_steps == 0:
        raise AssertionError(
            f"engine: launches {counts} (expected {want}), decode kernel "
            f"{flash}, ragged steps {ragged_steps}")
    if len(done) != n_requests or any(
            len(done[r]) != reqs[r][1]
            or min(done[r]) < 0 or max(done[r]) >= config.vocab_size
            for r in done):
        raise AssertionError("engine: a request was not served in full")

    compile_watch = compile_row(watcher, journal, registry, engine._shapes,
                                "engine")
    memory = ledger_row(acct, device)
    pairs = [(reqs[r][0], done[r]) for r in range(n_teacher)]
    teacher = {}
    if isinstance(config, moe.MoEConfig):
        agreement, t_routes = _moe_engine_teacher(params, config, device,
                                                  cache_len, pairs)
        teacher["route_flips_steps"] = _engine_step_flips(
            routes, marks[:n_teacher], t_routes, L)
        agree_min = MOE_TEACHER_AGREE_MIN
    else:
        agreement = _teacher_agreement(params, config, device, pairs)
        agree_min = TEACHER_AGREE_MIN
    del routes
    new_tokens = sum(len(t) for t in done.values())
    emit(dict(
        phase=phase, slots=slots, cache_len=cache_len, cache="int8",
        requests_served=len(done), new_tokens=new_tokens, steps=steps,
        ragged_steps=ragged_steps, serve_s=serve_s,
        tok_per_s=new_tokens / serve_s, launches=counts,
        kv_cache_bytes=engine.kv_cache_bytes(), kv_cache_claim=exact,
        memory=memory, compile_watch=compile_watch,
        teacher_forced_agreement=agreement, teacher_requests=n_teacher,
        teacher_agree_min=agree_min, route_drops=route_drops, **teacher,
    ))
    if agreement < agree_min:
        raise AssertionError(f"engine: teacher-forced agreement "
                             f"{agreement:.3f} < {agree_min}")
    return counts


# ---------------------------------------------------------------------------
# phase 7: the serving replica behind a master and a router
# ---------------------------------------------------------------------------

# the card run's prefix-cache budget: one full-width entry holds its
# bucket's rows of all 32 layers, 131 KB a token (67 MB at bucket 512,
# 268 MB at 2048), and the 64 MiB default would drop every one
SERVE_PREFIX_BYTES = 2 << 30
# the six spans of one routed request, router and replica side
SERVE_WATERFALL = ("serve.route", "serve.generate", "serve.queue_wait",
                   "serve.prefill_compute", "serve.first_step",
                   "serve.decode")
# queue + prefill + first step against the TTFT the batcher reports
# (the reference's tolerance)
SEGMENTS_TTFT_ABS_S = 0.25
# the eight files of a replica's flight-recorder bundle
BUNDLE_FILES = ["config.json", "incidents.json", "journal.json",
                "manifest.json", "metrics.prom", "stacks.txt", "traces.json",
                "worst_requests.json"]


def _http_get(addr, path, timeout_s=30.0, attempts=3):
    """GET ``http://addr/path``'s body, retried: a replica busy in Python
    copies answers late."""
    import urllib.request

    for attempt in range(attempts):
        try:
            with urllib.request.urlopen(f"http://{addr}{path}",
                                        timeout=timeout_s) as r:
                return r.read().decode()
        except OSError:
            if attempt + 1 == attempts:
                raise
            time.sleep(1.0 + attempt)


def _exemplar_ids(text, family):
    return {ln.split('trace_id="')[1].split('"')[0]
            for ln in text.splitlines()
            if ln.startswith(family + "_bucket") and "trace_id" in ln}


def _bundle_spans(bundle_path):
    """(trace_id, name, span_id, parent_id, seconds) of every span in a
    bundle's chrome trace."""
    with open(os.path.join(bundle_path, "traces.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["args"]["trace_id"], e["name"], e["args"]["span_id"],
             e["args"]["parent_id"], e["dur"] / 1e6)
            for e in events if e.get("ph") == "X" and e.get("cat") == "span"]


def span_cost_us(n=20000):
    """Microseconds a ``with span(...)`` costs on this host, tracing on
    and off (a private tracer; the process's ring is left alone)."""
    from dlrover_tpu_torch.observability import tracing

    out = {}
    for label, on in (("on", True), ("off", False)):
        tr = tracing.Tracer(enabled=on, ring_size=2048)
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("serve.decode", source="bench", request_id="r"):
                pass
        out[label] = (time.perf_counter() - t0) / n * 1e6
    return out


def serve_observability(a, b_http_addr, resps):
    """Phase 7's checks of the observability spine after its 32 routed
    requests: replica A's /metrics (the TTFT count equals A's completed
    requests; every exemplar is a trace in this process's ring),
    /events and /debug/bundle (the reference's eight files); each
    request one trace of the six serve.* spans (replica B's from its own
    bundle), queue + prefill + first step within SEGMENTS_TTFT_ABS_S of
    its TTFT. Returns the row's fields."""
    from dlrover_tpu_torch.observability import tracing

    tracer = tracing.get_tracer()
    local = tracer.finished_spans() + tracer.live_spans()
    ring_ids = {sp.trace_id for sp in local}
    metrics = _http_get(a.http_addr, "/metrics")
    count = [ln for ln in metrics.splitlines()
             if ln.startswith("dlrover_serving_ttft_seconds_count ")]
    ttft_count = int(float(count[0].split()[1])) if count else -1
    exemplars = (_exemplar_ids(metrics, "dlrover_serving_ttft_seconds")
                 | _exemplar_ids(metrics, "dlrover_serving_tpot_seconds"))
    events = json.loads(_http_get(a.http_addr, "/events"))
    kinds = sorted({e["kind"] for e in events["events"]})
    a_bundle = json.loads(_http_get(a.http_addr, "/debug/bundle"))
    b_bundle = json.loads(_http_get(b_http_addr, "/debug/bundle"))
    spans = {}
    for sp in local:
        spans.setdefault(sp.trace_id, []).append(
            (sp.name, sp.span_id, sp.parent_id,
             (sp.end_t or time.monotonic()) - sp.start_t))
    for tid, name, sid, pid, dur in _bundle_spans(b_bundle["path"]):
        spans.setdefault(tid, []).append((name, sid, pid, dur))
    incomplete, worst_gap = [], 0.0
    for r in resps:
        got = spans.get(r.trace_id, [])
        names = sorted(n for n, *_ in got if n.startswith("serve."))
        if names != sorted(SERVE_WATERFALL):
            incomplete.append((r.request_id, r.trace_id, names))
            continue
        seg = sum(d for n, _, _, d in got if n in SERVE_WATERFALL[2:5])
        worst_gap = max(worst_gap, abs(seg - r.ttft_s))
    row = dict(
        traces=len({r.trace_id for r in resps}), requests=len(resps),
        traces_incomplete=incomplete,
        segments_vs_ttft_max_abs_s=worst_gap,
        a_ttft_count=ttft_count, a_completed=a.batcher.completed,
        a_exemplars=len(exemplars),
        a_exemplars_not_in_ring=sorted(exemplars - ring_ids),
        a_journal_kinds=kinds, a_bundle_files=sorted(a_bundle["files"]),
        b_bundle_files=sorted(b_bundle["files"]),
        ring=tracer.counts(), span_cost_us=span_cost_us())
    problems = []
    if row["traces"] != len(resps) or incomplete:
        problems.append(f"{row['traces']} traces for {len(resps)} "
                        f"requests, incomplete {incomplete[:4]}")
    if worst_gap > SEGMENTS_TTFT_ABS_S:
        problems.append(f"segments off TTFT by {worst_gap:.3f} s")
    if ttft_count != a.batcher.completed or not exemplars:
        problems.append(f"A's TTFT count {ttft_count}, completed "
                        f"{a.batcher.completed}, {len(exemplars)} exemplars")
    if row["a_exemplars_not_in_ring"]:
        problems.append("exemplars outside the ring "
                        f"{row['a_exemplars_not_in_ring']}")
    if a.engine.hits and "serve_prefix_hit" not in kinds:
        problems.append(f"A's journal lacks its prefix hits: {kinds}")
    if (row["a_bundle_files"] != BUNDLE_FILES
            or row["b_bundle_files"] != BUNDLE_FILES):
        problems.append(f"bundle files {row['a_bundle_files']} "
                        f"{row['b_bundle_files']}")
    if problems:
        raise AssertionError("serve observability: " + "; ".join(problems))
    return row


def _wait_for(cond, timeout_s, what, proc=None):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited with "
                                 f"{proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(0.1)


def _serve_traffic(router, reqs, clients):
    """Every request through the router from ``clients`` threads:
    [(response, client-side seconds)] in request order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        t0 = time.perf_counter()
        resp = router.submit(reqs[i][0], reqs[i][1], request_id=f"q{i}")
        return resp, time.perf_counter() - t0

    with ThreadPoolExecutor(clients) as pool:
        return list(pool.map(one, range(len(reqs))))


# phase 7 serves the first 16 of LlamaConfig()'s 32 layers of phases 1-3's
# weights (full width): replica B warm-starts a 6.2 GB blob from A, not
# 11.9 GB (0.2-0.3 GB/s through the fabric), and every decode step runs
# half the layers
SERVE_LAYERS = 16


def serve_layers(params, config, n_layers=SERVE_LAYERS):
    """``params`` and ``config`` cut to their first ``n_layers`` layers
    (views of the stacked weights, no copy)."""
    return ({**params, "layers": {k: v[:n_layers]
                                  for k, v in params["layers"].items()}},
            dataclasses.replace(config, n_layers=n_layers))


def serve_phase(params, config, device, config_flag="llama", slots=8,
                cache_len=4096, buckets=(512, 1024, 2048), max_new_cap=64,
                n_prefixes=8, prefix_len=512, suffix_range=(16, 1024),
                new_range=(16, 48), clients=4, window_prompt=512,
                window_batch=16, window_runs=8, spec_prompt=512,
                spec_new=64, spec_k=4,
                start_timeout_s=600):
    """Replica A (in this process, around ``params``) and replica B (a
    subprocess through the replica's entry point, seed + 1, warm-started
    from A over the fabric) behind the port's master servicer and router;
    then ``decode_window`` and speculative decoding at full width.
    Returns the launch counts of the traffic and speculative runs."""
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.common.rpc import RPCClient, find_free_port
    from dlrover_tpu_torch.master.servicer import start_master
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving import replica as rep
    from dlrover_tpu_torch.serving.router import RequestRouter
    from dlrover_tpu_torch.serving.speculative import SpeculativeDecoder
    from dlrover_tpu_torch.serving.traffic import percentile

    L, V = config.n_layers, config.vocab_size
    saved_env = os.environ.get("DLROVER_TPU_SERVE_PREFIX_BYTES")
    os.environ["DLROVER_TPU_SERVE_PREFIX_BYTES"] = str(SERVE_PREFIX_BYTES)
    # replica A's shape keys land in this phase's own compile watch
    _, watcher, watch_journal, watch_registry = fresh_ledger()
    server, servicer = start_master()
    addr = f"127.0.0.1:{server.port}"
    flags = ["--backend", "torch", "--config", config_flag,
             "--n-layers", str(L),
             "--device", str(device), "--slots", str(slots),
             "--cache-len", str(cache_len),
             "--buckets", ",".join(str(b) for b in buckets),
             "--max-new-cap", str(max_new_cap), "--quantize",
             "--prefix-cache", "--hb-interval-s", "0.5"]
    args = rep.parse_args(["--master", addr, "--node-id", "1",
                           "--seed", str(SEED), *flags])
    # A's own registry: its /metrics is A's alone, not the router's too
    a = rep.DecodeReplica(addr, 1, rep._build_engine(args, params),
                          buckets=buckets, max_new_cap=max_new_cap,
                          heartbeat_interval_s=0.5,
                          registry=MetricsRegistry())
    b_http_addr = f"127.0.0.1:{find_free_port('127.0.0.1')}"
    inner = a.engine._engine
    b = None
    row = dict(phase="serve", slots=slots, cache_len=cache_len, cache="int8",
               buckets=list(buckets), prefix_cache_bytes=SERVE_PREFIX_BYTES)
    try:
        a.start()
        if device.type == "cuda" and not inner._flash:
            raise AssertionError("serve: replica A's engine does not take "
                                 "the decode kernel")
        # A's blob, made before B asks for it
        t0 = time.perf_counter()
        blob_bytes = a._provide_weights("current")[1]
        row["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.serving.replica",
             "--master", addr, "--node-id", "2", "--seed", str(SEED + 1),
             "--http-port", b_http_addr.rsplit(":", 1)[1], *flags],
            cwd=REPO)
        live = servicer.serve_registry.live
        _wait_for(lambda: len(live()) == 2, start_timeout_s,
                  "serve: replica B registering", b)
        _wait_for(lambda: "serve_weight_load_bytes" in (
            servicer.last_beat(2) or {}).get("gauges", {}), 60,
            "serve: replica B reporting its warm start", b)
        gauges = servicer.last_beat(2)["gauges"]
        b_addr = next(r["addr"] for r in live() if r["node_id"] == 2)
        row.update(b_start_s=time.perf_counter() - t0,
                   warm_start_bytes=gauges["serve_weight_load_bytes"],
                   warm_start_s=gauges["serve_weight_load_s"],
                   warm_start_gb_per_s=gauges["serve_weight_load_bytes"]
                   / gauges["serve_weight_load_s"] / 1e9)
        if gauges["serve_weight_load_bytes"] != blob_bytes:
            raise AssertionError("serve: replica B loaded "
                                 f"{gauges['serve_weight_load_bytes']} "
                                 f"bytes of A's {blob_bytes}")
        # B's fabric session claimed the blob's bytes as staging and
        # released them when the warm start ended
        b_mem = {ln.split("{", 1)[0] + ln[ln.index("{"):ln.index("}") + 1]:
                 float(ln.rsplit(" ", 1)[1])
                 for ln in _http_get(b_http_addr, "/metrics").splitlines()
                 if ln.startswith(("dlrover_memory_bytes{",
                                   "dlrover_memory_watermark_bytes{"))}
        row["b_staging"] = dict(
            claim_after=b_mem.get('dlrover_memory_bytes{category="staging"}'),
            watermark=b_mem.get(
                'dlrover_memory_watermark_bytes{category="staging"}'))
        if (row["b_staging"]["claim_after"] != 0
                or row["b_staging"]["watermark"] != blob_bytes):
            raise AssertionError(f"serve: B's staging claims "
                                 f"{row['b_staging']} for a {blob_bytes}-"
                                 f"byte warm start")

        # traffic: shared system prompts, every prompt once, then again
        rng = np.random.default_rng(SEED + 7)
        systems = [rng.integers(1, V, prefix_len).tolist()
                   for _ in range(n_prefixes)]
        prompts = [(systems[i % n_prefixes] + rng.integers(
            1, V, int(rng.integers(suffix_range[0], suffix_range[1] + 1)))
            .tolist(), int(rng.integers(new_range[0], new_range[1] + 1)))
            for i in range(2 * n_prefixes)]
        cold = rng.integers(1, V, prefix_len + suffix_range[1] // 2).tolist()
        router = RequestRouter(live, request_timeout_s=300.0)
        fa.reset_launch_counts()
        steps0 = a.batcher.steps
        _sync(device)
        t0 = time.perf_counter()
        first = _serve_traffic(router, prompts, clients)
        first_s = time.perf_counter() - t0
        # the second pass under the profiler: the share of its wall time
        # in which this process (replica A) kept the card busy (the rate
        # is read from the first pass: the trace's processing after the
        # window is not serving time)
        second = []
        a_profile = device_profile(
            lambda: second.extend(_serve_traffic(router, prompts, clients)),
            1, device, match="flash_decode")
        # the spine after the 32 routed requests: scrapes, traces, bundles
        row["observability"] = serve_observability(
            a, b_http_addr, [r for r, _ in first + second])
        # TTFT on a prefix hit against a miss, one request at a time on A:
        # a new suffix after a resident system prompt, or after a new one
        probe = {"hit": [], "miss": []}
        to_a = RPCClient(a.addr, timeout_s=300.0, retries=1)
        for i in range(4):
            for system in (systems[i], rng.integers(1, V, prefix_len)
                           .tolist()):
                hits0 = a.engine.hits
                resp = to_a.call("serve_generate", comm.ServeGenerateRequest(
                    request_id=f"ttft-{len(probe['hit'] + probe['miss'])}",
                    prompt=system + rng.integers(
                        1, V, suffix_range[1] // 2).tolist(),
                    max_new_tokens=2))
                if not resp.success:
                    raise AssertionError(f"serve: {resp.message}")
                probe["hit" if a.engine.hits > hits0 else "miss"].append(
                    resp.ttft_s)
        # one cold prompt to each replica: the same tokens show that B
        # serves A's weights
        direct = [RPCClient(x, timeout_s=300.0, retries=1).call(
            "serve_generate", comm.ServeGenerateRequest(
                request_id=f"cold-{x}", prompt=cold, max_new_tokens=32))
            for x in (a.addr, b_addr)]
        _sync(device)
        traffic_counts = _launches()
        steps = a.batcher.steps - steps0
        want = dict.fromkeys(fa.LAUNCHES, 0)
        want["flash_decode_int8"] = L * steps if inner._flash else 0
        if traffic_counts != want:
            raise AssertionError(f"serve: launches {traffic_counts}, "
                                 f"expected {want} ({steps} steps on A)")
        resps = [r for r, _ in first + second]
        failed = [r.message for r in resps + direct if not r.success]
        if failed or router.lost or a.batcher.failed:
            raise AssertionError(f"serve: failed {failed}, lost "
                                 f"{router.lost}, A's prefill failures "
                                 f"{a.batcher.failed}")
        if direct[0].tokens != direct[1].tokens:
            raise AssertionError("serve: A and B gave different tokens for "
                                 "one cold prompt after the warm start")
        a_stats = a.engine.stats()
        # B's gauges from a beat taken after the traffic ended
        t_done = time.monotonic()
        _wait_for(lambda: servicer.last_beat(2)["t"] > t_done, 30,
                  "serve: replica B's heartbeat after the traffic", b)
        b_gauges = servicer.last_beat(2)["gauges"]
        if a_stats["hits"] == 0 and b_gauges["serve_prefix_tokens_saved"] == 0:
            raise AssertionError("serve: no prefix-cache hit on A or B")
        # a reuse that raised would have fallen back to a cold prefill
        if a_stats["dropped"] or b_gauges["serve_prefix_dropped"]:
            raise AssertionError(
                f"serve: prefix reuses dropped: A {a_stats['dropped']}, "
                f"B {b_gauges['serve_prefix_dropped']}")
        agreement = _teacher_agreement(
            params, config, device,
            [(p, r.tokens) for (p, _), r in zip(prompts * 2, resps)])
        ttft = [r.ttft_s for r in resps]
        first_tokens = sum(len(r.tokens) for r, _ in first)
        second_tokens = sum(len(r.tokens) for r, _ in second)
        row.update(
            requests=len(resps), lost=router.lost, rerouted=router.rerouted,
            served_by_a=sum(r.replica_id == 1 for r in resps),
            first_pass_s=first_s, first_pass_new_tokens=first_tokens,
            tok_per_s=first_tokens / first_s,
            second_pass_tok_per_s_profiled=(
                second_tokens / a_profile["wall_ms"] * 1e3),
            a_steps=steps,
            a_tok_per_step=(sum(len(r.tokens) - 1 for r in resps
                                if r.replica_id == 1) / max(1, steps)),
            ttft_p50_s=percentile(ttft, 50), ttft_p99_s=percentile(ttft, 99),
            ttft_p50_first_pass_s=percentile([r.ttft_s for r, _ in first],
                                             50),
            ttft_p50_second_pass_s=percentile([r.ttft_s for r, _ in second],
                                              50),
            client_latency_p50_s=percentile([s for _, s in first + second],
                                            50),
            ttft_hit_s=probe["hit"], ttft_miss_s=probe["miss"],
            a_second_pass_profile=a_profile,
            launches=traffic_counts, a_prefix=a_stats,
            b_prefix_hit_rate=b_gauges["serve_prefix_hit_rate"],
            b_prefix_tokens_saved=b_gauges["serve_prefix_tokens_saved"],
            b_prefix_dropped=b_gauges["serve_prefix_dropped"],
            teacher_forced_agreement=agreement,
        )
        if agreement < TEACHER_AGREE_MIN:
            raise AssertionError(f"serve: teacher-forced agreement "
                                 f"{agreement:.3f} < {TEACHER_AGREE_MIN}")
        # B's tokens differ from a fresh seed + 1 model's: the weights it
        # serves came from A
        drained = RPCClient(b_addr, timeout_s=300.0, retries=1).call(
            "serve_drain", comm.ServeDrainRequest(reason="chip_smoke"))
        row["b_exit"] = b.wait(timeout=120)
        if not drained.success or row["b_exit"] != 0:
            raise AssertionError(f"serve: B drained {drained.success}, "
                                 f"exited {row['b_exit']}")
        fresh = llama.init_params(
            config, torch.Generator(device=device).manual_seed(SEED + 1),
            device)
        fresh_toks = decode.generate(
            fresh, torch.tensor([cold], device=device), config, None, 32,
            temperature=0.0)[0, len(cold):].tolist()
        del fresh
        if fresh_toks == direct[1].tokens:
            raise AssertionError("serve: B's tokens are a fresh seed + 1 "
                                 "model's: its warm start did not land")

        # prefix hits on A against their cold prefill, and their time
        hit_first = hit_rows = n_hits = 0
        hit_s = cold_s = 0.0
        rows_computed = []
        for prompt, _ in prompts:
            bucket = a.batcher.bucket_for(len(prompt))
            hits0, saved0 = a.engine.hits, a.engine.tokens_saved
            _sync(device)
            t0 = time.perf_counter()
            hit = a.engine.prefill_rows(prompt, bucket)
            _sync(device)
            t1 = time.perf_counter()
            ref = inner.prefill_rows(prompt, bucket)
            _sync(device)
            if a.engine.hits == hits0:
                continue
            n_hits += 1
            rows_computed.append(
                [bucket - (a.engine.tokens_saved - saved0), bucket])
            if n_hits == 1:
                # where a hit's and a cold prefill's time goes
                row["prefill_profile_hit"] = device_profile(
                    lambda: a.engine.prefill_rows(prompt, bucket), 1,
                    device)
                row["prefill_profile_cold"] = device_profile(
                    lambda: inner.prefill_rows(prompt, bucket), 1, device)
            hit_s += t1 - t0
            cold_s += time.perf_counter() - t1
            hit_first += hit.first_token == ref.first_token
            n = len(prompt)
            hit_rows = max(hit_rows, max(
                _rel_err(h[:, :, :n].float(), c[:, :, :n].float())
                for h, c in zip(hit.payload, ref.payload)))
            del hit, ref
        # a prefix hit's suffix prefill is keyed by its matched length,
        # which the second pass's replayed prompts spread over many
        # blocks: a churn of engine.prefill_sfx signatures the watch must
        # attribute to seq_len
        row["compile_watch"] = compile_row(
            watcher, watch_journal, watch_registry, inner._shapes, "serve",
            churning=("engine.prefill_sfx",))
        row.update(prefix_checks=n_hits,
                   prefix_rows_computed_of_bucket=rows_computed,
                   prefix_first_token_agreement=hit_first / max(1, n_hits),
                   prefix_rows_rel_err=hit_rows,
                   prefill_s_hit=hit_s / max(1, n_hits),
                   prefill_s_cold=cold_s / max(1, n_hits))
        if (not n_hits or hit_first / n_hits < TEACHER_AGREE_MIN
                or hit_rows > LOGITS_REL_TOL or a.engine.dropped):
            raise AssertionError(
                f"serve: {n_hits} prefix hits, first tokens as cold in "
                f"{hit_first}, rows rel err {hit_rows:.3g}, "
                f"{a.engine.dropped} reuses dropped on A")
    finally:
        if b is not None and b.poll() is None:
            b.kill()
            b.wait(timeout=60)
        a.stop()
        server.stop()
        if saved_env is None:
            os.environ.pop("DLROVER_TPU_SERVE_PREFIX_BYTES", None)
        else:
            os.environ["DLROVER_TPU_SERVE_PREFIX_BYTES"] = saved_env
    del a, inner
    # A's closures (its gauges, its journal hook) hold it in reference
    # cycles: only the cycle collector frees its engine, and until it
    # runs A's weights, cache and prefixes stay on the card
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit(row)
    row = dict(phase="serve_decode")

    # decode_window against K sequential decode steps, both caches, over
    # `window_runs` windows a row: on the continuation the steps choose
    # themselves (a self-draft's window) and on random window tokens.
    # Rounding flips near-ties, so besides the agreement a miss is held
    # to none where the steps' top-2 gap exceeds the largest logit error
    # this comparison measured.
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    prompt = torch.randint(0, V, (window_batch, window_prompt),
                           generator=gen, device=device)
    n_toks = window_runs * (spec_k + 1)
    rand_toks = torch.randint(0, V, (window_batch, n_toks), generator=gen,
                              device=device)
    T = window_prompt + n_toks
    for quantize, greedy in ((False, True), (True, True), (False, False),
                             (True, False)):
        logits, cache_s = decode.prefill(params, prompt, config, T, quantize)
        toks, seq = [], []
        for i in range(n_toks):
            tok = logits.argmax(-1) if greedy else rand_toks[:, i]
            toks.append(tok)
            logits, cache_s = decode.decode_step(params, tok, cache_s,
                                                 config)
            seq.append(logits)
        del cache_s
        seq = torch.stack(seq, dim=1)
        toks = torch.stack(toks, dim=1)
        _, cache_w = decode.prefill(params, prompt, config, T, quantize)
        win = []
        for w in range(0, n_toks, spec_k + 1):
            out, cache_w = decode.decode_window(
                params, toks[:, w:w + spec_k + 1], cache_w, config)
            win.append(out)
        del cache_w
        win = torch.cat(win, dim=1)
        finite = bool(torch.isfinite(win).all())
        err = _rel_err(win, seq)
        max_err = float((win - seq).abs().max())
        top2 = seq.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        miss = win.argmax(-1) != seq.argmax(-1)
        n_pos = miss.numel()
        beyond = int((miss & (gap > max_err)).sum())
        name = ("window_" + ("int8" if quantize else "bf16")
                + ("" if greedy else "_random_tokens"))
        row[name] = dict(
            logits_rel_err=err, max_abs_logit_err=max_err, positions=n_pos,
            positions_gap_over_err=int((gap > max_err).sum()),
            argmax_agreement=1.0 - float(miss.float().mean()),
            misses=int(miss.sum()), misses_beyond_err=beyond,
            agreement_beyond_err=1.0 - beyond / n_pos)
        del seq, win
        if (not finite or err > LOGITS_REL_TOL or beyond
                or row[name]["argmax_agreement"] < TEACHER_AGREE_MIN):
            raise AssertionError(f"serve: {name} vs steps {row[name]}")

    # speculative decoding: the target as its own draft, and a 2-layer
    # draft of the same width from another seed
    prompt = torch.randint(0, V, (1, spec_prompt), generator=gen,
                           device=device)
    plist = prompt[0].tolist()
    _sync(device)
    t0 = time.perf_counter()
    stock = decode.generate(params, prompt, config, None, spec_new,
                            temperature=0.0)[0, spec_prompt:].tolist()
    _sync(device)
    stock_s = time.perf_counter() - t0
    dcfg = dataclasses.replace(config, n_layers=2)
    draft = llama.init_params(
        dcfg, torch.Generator(device=device).manual_seed(SEED + 2), device)
    fa.reset_launch_counts()
    runs = {}
    for name, dp, dc in (("self_draft", params, config),
                         ("2_layer_draft", draft, dcfg)):
        spec = SpeculativeDecoder(params, config, dp, dc, k=spec_k)
        _sync(device)
        t0 = time.perf_counter()
        toks_s, stats = spec.generate(plist, spec_new)
        _sync(device)
        seconds = time.perf_counter() - t0
        runs[name] = dict(stats, seconds=seconds,
                          tok_per_s=spec_new / seconds, tokens=toks_s)
    spec_counts = _launches()
    del draft
    want = dict.fromkeys(fa.LAUNCHES, 0)
    if device.type == "cuda" and spec_prompt >= 256:
        want["flash_fwd"] = 3 * L + dcfg.n_layers  # the four prefills
    if spec_counts != want:
        raise AssertionError(f"serve: speculative launches {spec_counts}, "
                             f"expected {want}")
    for name, r in runs.items():
        r["teacher_forced_agreement"] = _teacher_agreement(
            params, config, device, [(plist, r.pop("tokens"))])
    row["speculative"] = dict(
        runs, prompt=spec_prompt, new_tokens=spec_new, k=spec_k,
        stock_generate_s=stock_s, stock_tok_per_s=spec_new / stock_s,
        stock_teacher_forced_agreement=_teacher_agreement(
            params, config, device, [(plist, stock)]),
        launches=spec_counts)
    emit(row)
    if (min(r["teacher_forced_agreement"] for r in runs.values())
            < TEACHER_AGREE_MIN
            or runs["self_draft"]["acceptance_rate"] < 0.9):
        raise AssertionError(
            "serve: speculative teacher-forced agreement "
            f"{[r['teacher_forced_agreement'] for r in runs.values()]}, "
            f"self-draft acceptance {runs['self_draft']['acceptance_rate']}")
    return {k: traffic_counts[k] + spec_counts[k] for k in traffic_counts}


# ---------------------------------------------------------------------------
# phase 9: the elastic serving plane (kill, re-route, restore; burst, grow)
# ---------------------------------------------------------------------------

def _decode_launches(gauges, n_layers):
    """Each replica's decode steps and K4 launches from its last beat, and
    the replicas whose launches are not one a layer a step."""
    rows, bad = {}, []
    for nid, g in gauges.items():
        steps = int(g.get("serve_decode_steps", 0))
        launches = int(g.get("serve_decode_kernel_launches", 0))
        rows[nid] = {"steps": steps, "launches": launches}
        if launches != n_layers * steps:
            bad.append(nid)
    return rows, bad


def _scrape_problems(scrapes, n_layers):
    """Replicas whose /metrics did not answer, or whose decode steps and
    K4 launches read there differ from their beat's."""
    if not scrapes:
        return ["no replica scraped"]
    out = []
    for nid, r in scrapes.items():
        if (r["error"] is not None or r["steps"] != r["beat_steps"]
                or r["launches"] != r["beat_launches"]
                or r["launches"] != n_layers * r["steps"]):
            out.append(f"replica {nid} scraped {r}")
    return out


def _bundle_digest(bundle):
    if bundle is None:
        return None
    manifest = bundle["manifest"]
    return dict(path=os.path.basename(bundle["path"]),
                node_id=manifest.get("node_id"), role=manifest.get("role"),
                files=sorted(manifest.get("files", [])),
                spans=manifest.get("spans_finished"),
                journal_events=manifest.get("journal_events"),
                victim_lost=bundle["victim_lost"],
                incidents=bundle["incidents"])


# phase 9's kill drill at 8 of LlamaConfig()'s 32 layers, at full width:
# its replacement warm-starts a 3.4 GB blob from the survivor, not 11.9
# GB (0.2-0.3 GB/s through the fabric), and its 48 requests decode 4x
# fewer layers; the burst drill keeps the whole depth, whose queue its
# grow and its SLO alert need
SERVE_KILL_LAYERS = 8


def serve_elastic_phase(config, device, config_flag="llama",
                        kill_layers=SERVE_KILL_LAYERS):
    """(a) the kill drill: two ``LlamaConfig()`` replicas at
    ``kill_layers`` layers as subprocesses (same seed, int8 cache, 8
    slots, cache_len 2048, buckets 256/512/1024), 48 requests from 8
    clients (prompts 64/200/500/1000, 32 new tokens), a SIGKILL of a
    replica with requests in flight once a third have completed (the
    ``serve.replica`` site's fault reported after it), the replacement
    spawned with another seed; (b) the burst drill: 1 replica, at most 2,
    under
    the reference's bursty ramp scaled to full-width prompts. Returns the
    K4 launches the replicas counted. ``config_flag`` is the replicas'
    ``--config`` (``tiny`` with a tiny ``config`` rehearses it on the
    CPU)."""
    from dlrover_tpu_torch.serving.drill import (
        GRACE_S,
        HEARTBEAT_S,
        LLAMA_DRILL,
        LLAMA_KILL_TRAFFIC,
        run_serving_drill,
        run_traffic_drill,
    )
    from dlrover_tpu_torch.serving.traffic import TrafficProfile

    common = dict(LLAMA_DRILL, config=config_flag, device=str(device),
                  seed=SEED)
    t0 = time.perf_counter()
    res = run_serving_drill(replicas=2, n_layers=kill_layers,
                            **LLAMA_KILL_TRAFFIC, **common)
    seconds = time.perf_counter() - t0
    journal = res["journal"]
    warm = res["warm_start"] or {}
    probe = res["probe_tokens"]
    restored, victim = res["restored_node"], res["killed_node"]
    survivor = next((n for n in probe if n != restored), None)
    row = dict(
        phase="serve_elastic_kill", seconds=seconds, requests=res["requests"],
        completed=res["completed"], lost=res["lost"],
        failed_responses=res["failed_responses"], rerouted=res["rerouted"],
        killed_node=victim, restored_node=restored,
        kill_detected=res["kill_detected"],
        replicas_restored=res["replicas_restored"],
        detect_s=res["detect_s"], restore_s=res["restore_s"],
        restore_timeout_s=LLAMA_KILL_TRAFFIC["restore_timeout_s"],
        heartbeat_s=HEARTBEAT_S, grace_s=GRACE_S,
        false_deaths=res["false_deaths"],
        warm_start_s=warm.get("seconds"), warm_start_bytes=warm.get("bytes"),
        warm_start_gb_per_s=(warm["bytes"] / warm["seconds"] / 1e9
                             if warm.get("seconds") else None),
        blob_bytes=res["blob_bytes"], tokens_per_s=res["tokens_per_s"],
        traffic_s=res["elapsed_s"], ttft_p50_s=res["ttft_p50_s"],
        ttft_p99_s=res["ttft_p99_s"],
        serving_goodput=res["serving_goodput"], journal=journal,
        probe_agrees=(survivor is not None and probe[survivor] is not None
                      and probe[survivor] == probe.get(restored)),
        # C12: the replicas' registrations and warm starts on the
        # journal's clock (the goodput window opens at the first)
        start_order=res["start_order"],
        replica_scrapes=res["replica_scrapes"],
        node_fault_bundle=_bundle_digest(res["node_fault_bundle"]))
    kill_rows, bad = _decode_launches(res["replica_gauges"], kill_layers)
    row["replicas"] = kill_rows
    row["n_layers"] = kill_layers
    emit(row)
    problems = []
    if bad:
        problems.append(f"K4 launches not {kill_layers} a step on "
                        f"replicas {bad}")
    if (res["lost"] or res["failed_responses"]
            or res["completed"] != res["requests"]):
        problems.append("requests lost, failed or not completed")
    if not (res["kill_detected"] and res["replicas_restored"]
            and res["rerouted"] >= 1):
        problems.append("the kill was not detected, re-routed and restored")
    if (journal.get("fault_injected", 0) < 1
            or journal.get("serve_replica_lost", 0) < 1
            or journal.get("serve_scale", 0) != 1):
        problems.append(f"journal {journal}")
    if res["false_deaths"]:
        problems.append(f"live replicas declared dead: {res['false_deaths']}")
    if not warm or warm["bytes"] != res["blob_bytes"]:
        problems.append(f"warm start {warm} against the survivor's blob of "
                        f"{res['blob_bytes']} bytes")
    if not row["probe_agrees"]:
        problems.append(f"probe tokens {probe}")
    problems += _scrape_problems(res["replica_scrapes"], kill_layers)
    bundle = res["node_fault_bundle"]
    if (bundle is None or bundle["manifest"].get("node_id") != victim
            or not bundle["victim_lost"]):
        problems.append("the master's node_fault bundle "
                        f"{row['node_fault_bundle']}")
    decoded = [n for n, r in kill_rows.items() if r["steps"]]
    if restored not in decoded or survivor not in decoded:
        problems.append(f"survivor or restored replica never decoded "
                        f"{row['replicas']}")
    if problems:
        raise AssertionError("serve_elastic (a): " + "; ".join(problems))

    profile = TrafficProfile(
        rps=30.0, duration_s=4.0, arrival="bursty", burst_factor=4.0,
        diurnal="ramp", length_mix=((0.7, 64, 512), (0.3, 512, 1024)),
        shared_prefix_frac=0.6, prefix_len=48, max_new_lo=16, max_new_hi=32,
        vocab=config.vocab_size, seed=SEED)
    t0 = time.perf_counter()
    res = run_traffic_drill(replicas=1, max_replicas=2, profile=profile,
                            request_timeout_s=600.0, **common)
    row = dict(phase="serve_elastic_burst", seconds=time.perf_counter() - t0,
               **{k: res[k] for k in (
                   "offered", "completed", "failed", "offered_rps",
                   "ttft_p50_s", "ttft_p99_s", "tokens_per_s", "lost",
                   "grow_events", "slo_alerts", "first_alert_t",
                   "first_grow_t", "slo_lead_s", "live_replicas_end",
                   "journal")})
    burst_rows, burst_bad = _decode_launches(res["replica_gauges"],
                                             config.n_layers)
    row["replicas"] = burst_rows
    row["replica_scrapes"] = res["replica_scrapes"]
    emit(row)
    scrape_bad = _scrape_problems(res["replica_scrapes"], config.n_layers)
    if scrape_bad:
        raise AssertionError(f"serve_elastic (b): {scrape_bad}")
    if (res["grow_events"] < 1 or res["lost"] or res["slo_alerts"] < 1
            or res["completed"] != res["offered"] or burst_bad):
        raise AssertionError(
            f"serve_elastic (b): {res['grow_events']} grows, {res['lost']} "
            f"lost, {res['slo_alerts']} SLO alerts, {res['completed']} of "
            f"{res['offered']} completed, K4 launches not "
            f"{config.n_layers} a step on replicas {burst_bad}")
    counts = dict.fromkeys(fa.LAUNCHES, 0)
    counts["flash_decode_int8"] = sum(
        r["launches"] for rows in (kill_rows, burst_rows)
        for r in rows.values())
    return counts


# ---------------------------------------------------------------------------
# phase 4: the training step at full width
# ---------------------------------------------------------------------------

# Kernel path vs dense path of one micro step of the 8-layer model, both
# bf16, relative to the dense value: the loss, and for every grad leaf
# (each stacked over the layers) its norm and ||g_kernel - g_dense|| /
# ||g_dense||. The paths round attention differently (the kernels round p
# and ds to bf16 before their products; the dense path rounds the f32
# softmax to bf16 before P V and runs its backward through autograd in
# bf16). The loss averages 8192 tokens and a leaf's norm sums its
# elements' squares, so both move far less than single elements; the
# difference of a leaf carries every element's rounding through 8 layers
# of backward. On an H100 (700 W) the gaps were 1.3e-5 (loss), at most
# 2.2e-4 (leaf norms) and 0.012-0.022 (leaf differences). A fault in K2 or
# K3 (say dk = 0) changes the wq, wk, wv leaves by the size of their
# gradient, far past these limits.
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_LEAF_NORM_REL_TOL = 1e-3
TRAIN_LEAF_DIFF_REL_TOL = 5e-2


def _matmul_params(c):
    """The weights a token passes through in matmuls: for a MoE config the
    active ones (the router and ``top_k`` experts a layer), so its MFU is
    counted by active parameters."""
    q_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    ffn = 3 * c.dim * c.ffn_dim
    if isinstance(c, moe.MoEConfig):
        ffn = c.top_k * ffn + c.dim * c.n_experts
    per_layer = c.dim * q_dim + 2 * c.dim * kv_dim + q_dim * c.dim + ffn
    return c.n_layers * per_layer + c.dim * c.vocab_size


def _family(c):
    """The model module of config ``c`` (llama or moe)."""
    return moe if isinstance(c, moe.MoEConfig) else llama




def _leaf_names(tree, prefix=""):
    """Dotted paths of a nested dict's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [name for key in sorted(tree)
                for name in _leaf_names(tree[key], f"{prefix}{key}.")]
    return [prefix[:-1]]


def _loss_and_grads(params, tokens, config):
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad(), record_routes(config) as routes:
        loss = _family(config).next_token_loss(
            tree_unflatten(params, live), tokens, config)
        grads = torch.autograd.grad(loss, live)
    # the forward's routing decisions (remat recomputes repeat them)
    return float(loss.detach()), grads, routes[:config.n_layers]


def kernel_vs_dense(params, tokens, config, loss_tol=None,
                    norm_tol=None, diff_tol=None, readings=None):
    """One micro step's loss and grads on the kernel path against the
    dense path (``use_flash_attention=False``), at the TRAIN_* limits
    unless given; for a MoE config with the routing decisions that differ
    between the two paths. The readings are returned, and also written
    into ``readings`` (a dict) before the limits are checked."""
    loss_tol = TRAIN_LOSS_REL_TOL if loss_tol is None else loss_tol
    norm_tol = TRAIN_LEAF_NORM_REL_TOL if norm_tol is None else norm_tol
    diff_tol = TRAIN_LEAF_DIFF_REL_TOL if diff_tol is None else diff_tol
    loss_k, grads_k, routes_k = _loss_and_grads(params, tokens, config)
    dense = dataclasses.replace(config, use_flash_attention=False)
    loss_d, grads_d, routes_d = _loss_and_grads(params, tokens, dense)
    leaves = {}
    for name, gk, gd in zip(_leaf_names(params), grads_k, grads_d):
        gk, gd = gk.float(), gd.float()
        nd = float(torch.linalg.vector_norm(gd))
        leaves[name] = dict(
            norm_rel=abs(float(torch.linalg.vector_norm(gk)) - nd) / nd,
            diff_rel=float(torch.linalg.vector_norm(gk - gd)) / nd)
    out = dict(loss=[loss_k, loss_d],
               loss_rel=abs(loss_k - loss_d) / abs(loss_d),
               grad_norm=[float(global_norm(grads_k)),
                          float(global_norm(grads_d))],
               leaves=leaves, limits=[loss_tol, norm_tol, diff_tol])
    if routes_k:
        out["route_flips"], out["route_decisions"] = route_flips(
            routes_k, routes_d)
    if readings is not None:
        readings.update(out)
    bad = [n for n, v in leaves.items()
           if not (v["norm_rel"] <= norm_tol and v["diff_rel"] <= diff_tol)]
    if bad or not out["loss_rel"] <= loss_tol:
        raise AssertionError(
            f"train: kernel vs dense outside loss {loss_tol}, leaf norm "
            f"{norm_tol}, leaf difference {diff_tol} (leaves {bad}): {out}")
    return out


def train_phase(config, device, global_batch, micro_batch, seq, steps, lr):
    """``ElasticTrainer.train_step`` fed as examples/llama_elastic_pretrain.py
    feeds it (sampler → loader → stack_microbatches, without worker.init and
    the checkpointer): ``steps`` counted steps on fresh batches, the kernel
    path against the dense path on one micro step, then one fixed batch for
    3 steps, the middle one profiled. Returns the counted launches."""
    c = config
    L = c.n_layers
    params = llama.init_params(
        c, torch.Generator(device=device).manual_seed(SEED + 1), device)
    opt = adamw(lr)
    trainer = ElasticTrainer(
        lambda p, t: llama.next_token_loss(p, t, c), opt, global_batch,
        micro_batch, device=device)
    accum = trainer.configure_for_world(plan_mesh(1))
    state = make_train_state(params, opt)
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, c.vocab_size, (global_batch * (steps + 2),
                                          seq + 1), dtype=np.int32)
    sampler = ElasticDistributedSampler(len(data), num_replicas=1, rank=0,
                                        shuffle=True, seed=SEED)
    loader = iter(ElasticDataLoader(data, trainer.micro_batch_global,
                                    sampler=sampler))

    def next_batch():
        batch = stack_microbatches([next(loader) for _ in range(accum)])
        sampler.record_batch(global_batch)
        return batch

    probe = [params["layers"]["wq"][0, :64, :64].clone(),
             params["lm_head"][:64, :64].clone()]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    acct, watcher, _journal, _registry = fresh_ledger()

    # the main path: `steps` train steps, counted
    fa.reset_launch_counts()
    losses, norms, step_s = [], [], []
    for _ in range(steps):
        batch = next_batch()
        _sync(device)
        t0 = time.perf_counter()
        state, res = trainer.train_step(state, batch)
        losses.append(float(res.loss))
        norms.append(float(res.grad_norm))
        step_s.append(time.perf_counter() - t0)
    counts = _launches()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = 2 * L * accum * steps  # forward + remat recompute
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = L * accum * steps
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    moved = [not torch.equal(a, b) for a, b in zip(
        probe, [params["layers"]["wq"][0, :64, :64],
                params["lm_head"][:64, :64]])]
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))
            and all(moved) and int(state["step"]) == steps):
        raise AssertionError(f"train: losses {losses}, grad norms {norms}, "
                             f"params moved {moved}")
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else None)
    # the trainer's claims: exactly its state's bytes (the params and the
    # optimizer state are what phase 5 saves, beside the step counter) and
    # the f32 accumulators a step allocates at each param's full shape
    leaves = tree_leaves(state["params"])
    want_claims = {
        "params": sum(t.numel() * t.element_size() for t in leaves),
        "opt_state": sum(t.numel() * t.element_size()
                         for t in tree_leaves(state["opt_state"])
                         if isinstance(t, torch.Tensor)),
        "activations": sum(4 * t.numel() for t in leaves)}
    got_claims = {c: acct.bytes_for(c) for c in want_claims}
    step_bytes = state["step"].numel() * state["step"].element_size()
    if (got_claims != want_claims or got_claims["params"]
            + got_claims["opt_state"] + step_bytes != _state_bytes(state)):
        raise AssertionError(f"train: ledger claims {got_claims}, state "
                             f"{want_claims}, saved bytes "
                             f"{_state_bytes(state)}")
    train_memory = dict(ledger_row(acct, device), claims=got_claims,
                        state_bytes=_state_bytes(state))
    train_compile = dict(
        compile_total=watcher.compile_count("trainer.train_step"),
        misses=watcher.misses())
    if train_compile["compile_total"] != 1:
        raise AssertionError(f"train: {train_compile['compile_total']} "
                             f"step signatures at one batch shape")

    # kernel path vs dense path on one micro step
    fixed = next_batch()
    versus_dense = kernel_vs_dense(
        params, torch.as_tensor(fixed[0]).to(device), c)

    # one fixed batch, 3 steps: its loss must fall step over step
    fixed_losses = []

    def fixed_step():
        nonlocal state
        state, res = trainer.train_step(state, fixed)
        fixed_losses.append(float(res.loss))

    fixed_step()
    profile = device_profile(fixed_step, 1, device, top=12)
    fixed_step()
    if not all(b < a for a, b in zip(fixed_losses, fixed_losses[1:])):
        raise AssertionError(f"train: fixed-batch loss did not fall: "
                             f"{fixed_losses}")

    # the f32 lm_head product (TF32 off): 3 GEMMs a micro step
    x32 = torch.randn((micro_batch * seq, c.dim), device=device)
    w32 = torch.randn((c.dim, c.vocab_size), device=device)
    lm_head_ms = time_ms(lambda: torch.matmul(x32, w32), 5, device)
    del x32, w32

    tokens = global_batch * seq
    step_mean = float(np.mean(step_s[1:])) if steps > 1 else step_s[0]
    flops = (6 * _matmul_params(c) * tokens
             + 12 * c.head_dim * _visible_pairs(seq, seq, True)
             * global_batch * c.n_heads * L)
    emit(dict(
        phase="train", config=dict(dim=c.dim, n_layers=L, n_heads=c.n_heads,
                                   n_kv_heads=c.n_kv_heads,
                                   ffn_dim=c.ffn_dim, vocab=c.vocab_size,
                                   remat=c.remat,
                                   remat_policy=c.remat_policy),
        num_params=llama.num_params(c), global_batch=global_batch,
        micro_batch=micro_batch, grad_accum=accum, seq_len=seq,
        steps=steps, losses=losses, grad_norms=norms, step_s=step_s,
        step_s_mean_after_first=step_mean, tokens_per_s=tokens / step_mean,
        model_flops_per_step=flops,
        mfu=flops / step_mean / BF16_FLOP_PER_S, launches=counts,
        peak_memory_gb=peak_gb,
        kernel_vs_dense=versus_dense,
        fixed_batch_losses=fixed_losses, step_profile=profile,
        memory=train_memory, compile_watch=train_compile,
        lm_head_f32_gemm_ms=lm_head_ms,
        lm_head_f32_share_of_step=3 * accum * lm_head_ms / 1e3 / step_mean,
    ))
    batch_shape = (accum, trainer.micro_batch_global, seq + 1)
    return counts, dict(config=c, state=state, trainer=trainer,
                        batch_shape=batch_shape, step_s=step_mean)


# ---------------------------------------------------------------------------
# the moe phase: Mixtral 8x7B widths, serving at 8 layers, training at 2
# ---------------------------------------------------------------------------

# The depth cuts: 32 layers (46.7B parameters, 93 GB in bf16) do not fit one
# card; 8 layers are 11.87B parameters (23.7 GB), 2 layers with f32 moments
# and accumulators a 44.3 GB train state.
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 2
# Kernel route against plain route on MoE logits. The two attention paths
# round differently in bf16, and a token whose router choices are near a
# tie (random weights put the router's logits at N(0, 1), their gaps at a
# few tenths) can take another expert, or the same two in the other order,
# on the other path: a route flip. A flipped token's FFN output changes
# outright, so it flips again in most later layers, and through capacity
# it may move another token of its group past or back under capacity. On
# an H100 (700 W) 7404 of the 131,072 prefill decisions of 8 layers at
# batch 8 x 1024 flipped (5.6%), and 5 and 12 of the 128 first-step
# decisions (3.9%, 9.4%, bf16 and int8 cache). With K1's softmax scale
# 1.1x too large (--control k1_scale=1.1) 34.5% of the prefill decisions
# flipped, with K4's (k4_scale=1.1) 18.8-20.3% of the step's. So the flips
# are held to MOE_FLIP_SHARE_MAX of the decisions, between those, and the
# logits at LOGITS_REL_TOL on the rows whose token routed alike in every
# layer on both paths (6 and 4-5 of 8 rows, errors 0.021-0.023; 0.174 on
# the step with k4_scale=1.1; 0.26 over all rows); no such row at all also
# fails (k1_scale leaves none); a greedy token may differ only where the
# plain route's top-2 gap is within the row's largest logit error.
MOE_FLIP_SHARE_MAX = 0.15
# The MoE engine's tokens against its teacher (_moe_engine_teacher): the
# same routing groups, the plain route's bf16 cache and dense attend (the
# engine's prefill attends dense too, so this holds the decode kernel,
# K4, and the batching; the routing itself is held by moe_route_check). A
# dense forward over the whole sequence is no teacher here: it routes the
# sequence as one group, and at capacity 1.25 the engine's prefills drop
# choices it would keep (38,591 dropped on an H100, 700 W; such a teacher
# agreed on 0.47 of the tokens). This one agreed on 0.817 with 84 of the
# 1424 step decisions flipped (5.9%); with K4's softmax scale 1.1x too
# large on 0.505 (389 flipped), 1.41x on 0.118. The step route flips are
# printed beside the agreement.
MOE_TEACHER_AGREE_MIN = 0.7
# Kernel path against dense path of one MoE micro step (2 layers, 4 x
# 2048 tokens): a flipped token moves its gradient to another expert and
# sends another hidden state on through the layers, so every leaf differs
# by more than the attention rounding alone gives the Llama step
# (TRAIN_*). On an H100 (700 W) 419 of the 32,768 forward decisions
# flipped (1.3%); the loss differed by 3.7e-5, the leaf norms by at most
# 4.8e-3 (the router), the leaves themselves by 0.056-0.163 of their norm.
# A fault in K2 or K3 (dk = 0) moves wq, wk, wv by their whole gradient.
# Held with the flips printed beside them.
MOE_TRAIN_LOSS_REL_TOL = TRAIN_LOSS_REL_TOL
MOE_TRAIN_LEAF_NORM_REL_TOL = 1e-2
MOE_TRAIN_LEAF_DIFF_REL_TOL = 0.3


# The port's routing and expert FFN against the reference's one-hot form
# (moe_route_check): the dispatch must be equal entry for entry; the
# outputs may differ only where bf16 rounds (the port sums a token's two
# choices in f32 and casts once, the one-hot combine is a bf16 product);
# on an H100 (700 W) both layers read 0, bitwise equal.
MOE_ROUTE_REL_TOL = 1e-2
# The sp routing fold (moe_sp_fold): the chunks' aux term sums the router
# probabilities per chunk and adds the sums, the whole sequence's takes
# their mean: f32 rounding apart.
MOE_FOLD_AUX_REL_TOL = 1e-5
# The controls (``--moe --control NAME``): the moe phase's checks with one
# kernel deliberately wrong, each of which must fail through the phase's
# own assertion. ``k1_scale=F``: K1 computes the softmax with its scale
# times F (the forward only; the backward keeps the right scale), which
# the generate and train checks see (the engine's prefill attends dense).
# ``k4_scale=F``: K4 likewise, which the generate and engine checks see.
# ``dk0``: K3 returns dk = 0 (dv kept), so wk takes no gradient through
# attention, which the train check sees.
MOE_CONTROLS = ("k1_scale=F", "k4_scale=F", "dk0")


def _moe_rows_alike(routes_k, routes_p, token):
    """``(B,)`` bool: whether each row's ``token`` (an index into each
    call's group axis) routed alike in every recorded layer on both paths
    (one group a row: the prefill's and the decode step's layout)."""
    alike = None
    for (ek, kk), (ep, kp) in zip(routes_k, routes_p):
        same = ((ek[:, token] == ep[:, token])
                & (kk[:, token] == kp[:, token])).all(-1)
        alike = same if alike is None else alike & same
    return alike


def _rows_rel_err(out, ref, rows):
    """The largest error over the selected rows, relative to the
    reference's largest logit there (the serving limit's scale)."""
    if not bool(rows.any()):
        return 0.0
    return _rel_err(out[rows], ref[rows])


def _greedy_misses(out, ref, rows):
    """Rows where the argmax differs although the reference's top-2 gap
    exceeds the row's largest logit error."""
    top2 = torch.topk(ref, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    err = (out - ref).abs().amax(-1)
    miss = (out.argmax(-1) != ref.argmax(-1)) & (gap > err) & rows
    return int(miss.sum())


def _moe_ffn_onehot(x, layer, c):
    """The reference's routed-expert FFN written as it is there
    (``dlrover_tpu/models/moe.py`` ``_route`` and ``_moe_ffn``), with no
    code of the port's routing: top-k by repeated argmax (the lower index
    first on ties, as ``lax.top_k``), positions as an f32 cumsum over the
    choice-major one-hot masks, the (G, g, E, C) dispatch and combine
    tensors and the four einsums. Returns ``(out, dispatch)``."""
    B, S, D = x.shape
    E, k = c.n_experts, c.top_k
    C = moe.expert_capacity(c, B, S)
    g = S if c.route_group_size is None else c.route_group_size
    G = B * S // g
    xg = x.reshape(G, g, D)
    probs = torch.softmax(torch.matmul(xg.float(), layer["router"]), -1)
    left, topv, topi = probs.clone(), [], []
    for _ in range(k):
        i = left.argmax(-1)
        topi.append(i)
        topv.append(probs.gather(-1, i[..., None])[..., 0])
        left = left.scatter(-1, i[..., None], float("-inf"))
    topv, topi = torch.stack(topv, -1), torch.stack(topi, -1)
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    masks = (topi[..., None] == torch.arange(E, device=x.device)).float()
    cm = masks.permute(0, 2, 1, 3)                        # (G, k, g, E)
    positions = (torch.cumsum(cm.reshape(G, k * g, E), 1)
                 .reshape(G, k, g, E) - 1.0)
    keep = (positions < C).float() * cm
    pos_in_expert = (positions * cm).sum(-1).long()       # (G, k, g)
    slot = (pos_in_expert[..., None]
            == torch.arange(C, device=x.device)).float()
    oh = keep[..., None] * slot[:, :, :, None, :]         # (G, k, g, E, C)
    dispatch = oh.sum(1)
    combine = (oh * gates.permute(0, 2, 1)[..., None, None]).sum(1)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)
    gate = torch.nn.functional.silu(
        torch.einsum("gecd,edf->gecf", expert_in, layer["w1"]))
    up = torch.einsum("gecd,edf->gecf", expert_in, layer["w3"])
    expert_out = torch.einsum("gecf,efd->gecd", gate * up, layer["w2"])
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, D), dispatch


def moe_route_check(params, c, device, batch=2, seq=1024):
    """The port's routing and expert FFN (``moe._route``, ``_moe_ffn``)
    on the card against :func:`_moe_ffn_onehot`, on the first and the last
    layer at Mixtral width: ``batch`` rows of ``seq`` random tokens'
    embeddings, RMS-normed as the layer's FFN input. Held: the dispatch
    (each kept choice's expert and slot) equal in every entry, the outputs
    within MOE_ROUTE_REL_TOL of the reference's largest."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    tokens = torch.randint(0, c.vocab_size, (batch, seq), generator=gen,
                           device=device)
    C = moe.expert_capacity(c, batch, seq)
    rows = []
    for li in sorted({0, c.n_layers - 1}):
        layer = llama.layer_params(params, li)
        x = llama.rms_norm(params["tok_embed"][tokens], layer["ffn_norm"],
                           c.norm_eps)
        out, _ = moe._moe_ffn(x, layer, c)
        expert, slot, kept, _, _ = moe._route(
            x.reshape(batch, seq, -1), layer["router"], c, C)
        port = torch.zeros((batch, seq, c.n_experts, C), device=device)
        hit = kept.nonzero(as_tuple=True)
        port[hit[0], hit[1], expert[hit], slot[hit]] = 1.0
        ref, dispatch = _moe_ffn_onehot(x, layer, c)
        rows.append(dict(layer=li,
                         dispatch_entries_differ=int((port != dispatch)
                                                     .sum()),
                         kept=int(kept.sum()),
                         dropped=int((~kept).sum()),
                         rel_err=_rel_err(out.float(), ref.float())))
    row = dict(phase="moe_route", batch=batch, seq=seq, capacity=C,
               layers=rows, limit=MOE_ROUTE_REL_TOL)
    emit(row)
    if any(r["dispatch_entries_differ"] or r["rel_err"] > MOE_ROUTE_REL_TOL
           for r in rows):
        raise AssertionError(f"moe route: the port's routing against the "
                             f"reference's one-hot form: {row}")


def moe_sp_fold(params, c, device, chunks=4, seq=2048):
    """The sequence-parallel routing fold on the card: one sequence of
    ``chunks`` × ``seq`` tokens (random tokens' embeddings, RMS-normed as
    the first layer's FFN input, one routing group) routed whole
    (``moe._route``) and as ``chunks`` sp chunks through the gathered-ids
    path (``moe.fold_routes`` of each chunk's share of the same choices,
    as the sp ranks gather them). Held: every chunk's experts, slots and
    kept flags equal to the whole sequence's exactly, its aux term within
    MOE_FOLD_AUX_REL_TOL. The capacity factor is 1.0, so that choices
    drop (at 1.25 none did on the card). Prints its seconds and the
    choices dropped."""
    t0 = time.perf_counter()
    c = dataclasses.replace(c, capacity_factor=1.0)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    S = chunks * seq
    tokens = torch.randint(0, c.vocab_size, (1, S), generator=gen,
                           device=device)
    layer = llama.layer_params(params, 0)
    x = llama.rms_norm(params["tok_embed"][tokens], layer["ffn_norm"],
                       c.norm_eps)
    C, g = moe.expert_capacity(c, 1, S), moe._group_size(c, 1, S)
    expert, slot, kept, _, aux = moe._route(x, layer["router"], c, C)
    probs, ex, gates = moe._choices(x, layer["router"], c)
    folded = moe.fold_routes(
        [tuple(t[:, r * seq:(r + 1) * seq] for t in (probs, ex, gates))
         for r in range(chunks)], c, C, g)
    differ = {}
    for i, (name, whole) in enumerate((("expert", expert), ("slot", slot),
                                       ("kept", kept))):
        got = torch.cat([out[i] for out in folded], dim=1)
        differ[name] = int((got != whole.reshape(got.shape)).sum())
    aux_rel = max(_rel(float(out[4]), float(aux)) for out in folded)
    _sync(device)
    row = dict(phase="moe_sp_fold", chunks=chunks, chunk_len=seq,
               capacity=C, group=g, differ=differ, aux_rel=aux_rel,
               aux_limit=MOE_FOLD_AUX_REL_TOL, dropped=int((~kept).sum()),
               decisions=kept.numel(), seconds=time.perf_counter() - t0)
    emit(row)
    if any(differ.values()) or aux_rel > MOE_FOLD_AUX_REL_TOL:
        raise AssertionError(f"moe sp fold: the chunks' routing against "
                             f"the whole sequence's: {row}")


def moe_generate(params, c, device, tag, batch, prompt_len, new, quantize,
                 max_len):
    """``decode.generate`` on the MoE model (the main path, counted: K1 a
    layer for the prefill, K4 a layer a decode step), then the kernel
    route's prefill and first step against the plain route's (dense
    attend, no decode kernel) with the route flips between them, and both
    routes' greedy tokens. Returns the counted launches."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7 + prompt_len)
    prompt = torch.randint(0, c.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    total = prompt_len + new
    T, flash = decode.planned_cache_len(total, quantize, max_len,
                                        device=device)
    L = c.n_layers
    fa.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    out = decode.generate(params, prompt, c, None, new, temperature=0.0,
                          max_len=max_len, quantize_cache=quantize)
    _sync(device)
    generate_s = time.perf_counter() - t0
    counts = _launches()
    k4 = "flash_decode_int8" if quantize else "flash_decode_bf16"
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = L
    want[k4] = L * (new - 1)
    if counts != want or not flash:
        raise AssertionError(f"moe generate {tag}: launches {counts}, "
                             f"expected {want} (decode kernel {flash})")
    if (tuple(out.shape) != (batch, total)
            or not torch.equal(out[:, :prompt_len].long(), prompt)
            or int(out.min()) < 0 or int(out.max()) >= c.vocab_size):
        raise AssertionError(f"moe generate {tag}: malformed output")

    dense = dataclasses.replace(c, use_flash_attention=False)
    _sync(device)
    t0 = time.perf_counter()
    with record_routes(c) as pre_k:
        logits, cache = decode.prefill(params, prompt, c, T, quantize)
    _sync(device)
    ttft_s = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)
    with record_routes(c) as step_k:
        step_logits, cache = decode.decode_step(params, tok, cache, c,
                                                flash=flash)
    # the decode rate on the kernel route, and where a step's time goes
    state = {"tok": torch.argmax(step_logits, dim=-1), "cache": cache}

    def step():
        lg, state["cache"] = decode.decode_step(params, state["tok"],
                                                state["cache"], c,
                                                flash=flash)
        state["tok"] = torch.argmax(lg, dim=-1)

    step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(8):
        step()
    _sync(device)
    decode_step_ms = (time.perf_counter() - t0) * 1e3 / 8
    profile = device_profile(step, 4, device, top=8, check_reader=True)
    del cache, state
    os.environ["DLROVER_TPU_FLASH_DECODE"] = "0"
    try:
        with record_routes(c) as pre_p:
            ref_logits, ref_cache = decode.prefill(params, prompt, dense, T,
                                                   quantize)
        with record_routes(c) as step_p:
            ref_step, _ = decode.decode_step(params, tok, ref_cache, dense)
        del ref_cache
        plain_out = decode.generate(params, prompt, dense, None, new,
                                    temperature=0.0, max_len=max_len,
                                    quantize_cache=quantize)
    finally:
        del os.environ["DLROVER_TPU_FLASH_DECODE"]
    pre_flips, pre_total = route_flips(pre_k, pre_p)
    step_flips, step_total = route_flips(step_k, step_p)
    pre_rows = _moe_rows_alike(pre_k, pre_p, prompt_len - 1)
    step_rows = pre_rows & _moe_rows_alike(step_k, step_p, 0)
    new_k, new_p = out[:, prompt_len:], plain_out[:, prompt_len:]
    diverge = [int((new_k[b] != new_p[b]).nonzero()[0]) if bool(
        (new_k[b] != new_p[b]).any()) else new for b in range(batch)]
    row = dict(
        phase="moe_generate", run=tag, layers=L, batch=batch,
        prompt_len=prompt_len, new_tokens=new,
        cache=("int8" if quantize else "bf16"), cache_len=T,
        decode_kernel=flash, generate_s=generate_s, ttft_s=ttft_s,
        launches=counts,
        decode_step_ms=decode_step_ms, decode_step_profile=profile,
        route_flips_prefill=[pre_flips, pre_total],
        route_flips_prefill_by_layer=[route_flips([a], [b])[0]
                                      for a, b in zip(pre_k, pre_p)],
        route_flips_step=[step_flips, step_total],
        rows_routed_alike=[int(pre_rows.sum()), int(step_rows.sum())],
        logits_rel_err_prefill=_rows_rel_err(logits, ref_logits, pre_rows),
        logits_rel_err_step=_rows_rel_err(step_logits, ref_step, step_rows),
        logits_rel_err_prefill_all_rows=_rel_err(logits, ref_logits),
        greedy_misses=[_greedy_misses(logits, ref_logits, pre_rows),
                       _greedy_misses(step_logits, ref_step, step_rows)],
        greedy_tokens_equal_share=float((new_k == new_p).float().mean()),
        greedy_first_divergence=diverge,
        limits=dict(logits_rel=LOGITS_REL_TOL,
                    flip_share=MOE_FLIP_SHARE_MAX))
    emit(row)
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(step_logits).all())
    if (not finite
            or max(row["logits_rel_err_prefill"],
                   row["logits_rel_err_step"]) > LOGITS_REL_TOL
            or pre_flips > MOE_FLIP_SHARE_MAX * pre_total
            or step_flips > MOE_FLIP_SHARE_MAX * step_total
            or any(row["greedy_misses"])
            or not bool(step_rows.any())):
        raise AssertionError(f"moe generate {tag}: kernel vs plain route "
                             f"outside its limits: {row}")
    return counts


def moe_train(c, device, global_batch, micro_batch, seq, steps, lr):
    """``ElasticTrainer`` on the MoE loss of config ``c``: ``steps``
    counted steps (K1 = 2·L·accum, K2 = K3 = L·accum a step under remat
    "dots"), the kernel path against the dense path on one micro step with
    the route flips between them, MFU by active parameters, the peak
    memory. Returns the counted launches."""
    L = c.n_layers
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = moe.init_params(
        c, torch.Generator(device=device).manual_seed(SEED + 3), device)
    opt = adamw(lr)
    trainer = ElasticTrainer(lambda p, t: moe.next_token_loss(p, t, c), opt,
                             global_batch, micro_batch, device=device)
    accum = trainer.configure_for_world(plan_mesh(1))
    state = make_train_state(params, opt)
    rng = np.random.default_rng(SEED + 3)
    batches = rng.integers(0, c.vocab_size, (steps + 1, accum,
                                             trainer.micro_batch_global,
                                             seq + 1), dtype=np.int32)
    fa.reset_launch_counts()
    losses, norms, step_s = [], [], []
    for b in batches[:steps]:
        _sync(device)
        t0 = time.perf_counter()
        state, res = trainer.train_step(state, b)
        losses.append(float(res.loss))
        norms.append(float(res.grad_norm))
        step_s.append(time.perf_counter() - t0)
    counts = _launches()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = 2 * L * accum * steps
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = L * accum * steps
    if counts != want:
        raise AssertionError(f"moe train: launches {counts}, expected "
                             f"{want}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))
            and int(state["step"]) == steps):
        raise AssertionError(f"moe train: losses {losses}, grad norms "
                             f"{norms}")
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else None)
    state_gb = _state_bytes(state) / 1e9

    def one_step():
        nonlocal state
        state, _ = trainer.train_step(state, batches[0])

    profile = device_profile(one_step, 1, device, top=12, check_reader=True)
    tokens = global_batch * seq
    step_mean = float(np.mean(step_s[1:])) if steps > 1 else step_s[0]
    flops = (6 * _matmul_params(c) * tokens
             + 12 * c.head_dim * _visible_pairs(seq, seq, True)
             * global_batch * c.n_heads * L)
    row = dict(
        phase="moe_train", layers=L, num_params=moe.num_params(c),
        global_batch=global_batch, micro_batch=micro_batch,
        grad_accum=accum, seq_len=seq, steps=steps, losses=losses,
        grad_norms=norms, step_s=step_s, step_s_mean_after_first=step_mean,
        tokens_per_s=tokens / step_mean, model_flops_per_step=flops,
        mfu_active=flops / step_mean / BF16_FLOP_PER_S, launches=counts,
        state_gb=state_gb, peak_memory_gb=peak_gb, step_profile=profile)
    row["kernel_vs_dense"] = {}
    try:
        kernel_vs_dense(
            params, torch.as_tensor(batches[steps][0]).to(device), c,
            MOE_TRAIN_LOSS_REL_TOL, MOE_TRAIN_LEAF_NORM_REL_TOL,
            MOE_TRAIN_LEAF_DIFF_REL_TOL, readings=row["kernel_vs_dense"])
    finally:
        emit(row)
    del state, params, trainer
    return counts


def _install_control(name):
    """Make one kernel wrong for a control run (see MOE_CONTROLS):
    ``k1_scale=F`` or ``dk0``. The real wrapper still launches and counts
    its kernel."""
    kind, _, arg = name.partition("=")
    if kind == "k1_scale":
        factor = float(arg)
        real_fwd = fa._flash_fwd_cuda

        def fwd(q, k, v, causal, scale):
            return real_fwd(q, k, v, causal, scale * factor)

        fa._flash_fwd_cuda = fwd
        return ("generate_bf16", "generate_int8", "train")
    if kind == "k4_scale":
        factor = float(arg)
        real_dec = fa._flash_decode_cuda

        def dec(q, k, v, pos, scale, k_scale, v_scale):
            return real_dec(q, k, v, pos, scale * factor, k_scale, v_scale)

        fa._flash_decode_cuda = dec
        return ("generate_bf16", "generate_int8", "engine")
    if kind == "dk0":
        real_dkv = fa._flash_bwd_dkv_cuda

        def dkv(*args):
            dk, dv = real_dkv(*args)
            return torch.zeros_like(dk), dv

        fa._flash_bwd_dkv_cuda = dkv
        return ("train",)
    raise SystemExit(f"chip_smoke: unknown control {name!r} (one of "
                     f"{', '.join(MOE_CONTROLS)})")


def moe_phase(device, base=None, control=None):
    """The Mixtral-class MoE path (module docstring): serving at
    MOE_SERVE_LAYERS layers (the routing against the reference's one-hot
    form, generate on the bf16 and the int8 cache, the engine on ragged
    slots), then training at MOE_TRAIN_LAYERS layers, of ``base``
    (default: Mixtral 8x7B). Returns the counted launches of each run.

    With ``control`` (see MOE_CONTROLS) one kernel is made wrong first and
    each check that runs it is run on its own: the phase then prints which
    checks failed and returns the names of those that passed (a sound
    control leaves none)."""
    t0 = time.perf_counter()
    checks = _install_control(control) if control else None
    outcome = {}

    def check(name, fn):
        if checks is None:
            return fn()
        if name not in checks:
            return None
        try:
            fn()
            outcome[name] = "passed"
        except AssertionError as e:
            outcome[name] = "failed: " + str(e)[:240]
        return None

    base = base or moe.MoEConfig.mixtral8x7b()
    c = dataclasses.replace(base, n_layers=MOE_SERVE_LAYERS)
    # what earlier phases still hold on the card when this one starts
    resident_gb = (torch.cuda.memory_allocated(device) / 1e9
                   if device.type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = moe.init_params(
        c, torch.Generator(device=device).manual_seed(SEED + 2), device)
    total, active = moe.num_params(c)
    emit({"phase": "moe_params", "layers": c.n_layers, "num_params": total,
          "active_params": active,
          "bytes": sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))})
    if checks is None:
        moe_route_check(params, c, device)
        moe_sp_fold(params, c, device)
    counts = [
        check("generate_bf16", lambda: moe_generate(
            params, c, device, "bf16", batch=8, prompt_len=1024, new=32,
            quantize=False, max_len=4096)),
        check("generate_int8", lambda: moe_generate(
            params, c, device, "int8", batch=8, prompt_len=1024, new=32,
            quantize=True, max_len=None)),
        check("engine", lambda: engine_phase(
            params, c, device, slots=8, cache_len=4096, n_requests=8,
            len_range=(100, 1500), new_range=(16, 32), n_teacher=4,
            phase="moe_engine")),
    ]
    serve_peak = (torch.cuda.max_memory_allocated(device) / 1e9
                  if device.type == "cuda" else None)
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    counts.append(check("train", lambda: moe_train(
        dataclasses.replace(base, n_layers=MOE_TRAIN_LAYERS), device,
        global_batch=8, micro_batch=4, seq=2048, steps=3, lr=3e-4)))
    emit({"phase": "moe", "seconds": time.perf_counter() - t0,
          "resident_at_start_gb": resident_gb,
          "serve_peak_memory_gb": serve_peak,
          "card": _card() if device.type == "cuda" else "not measured"})
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if checks is not None:
        emit({"phase": "moe_control", "control": control,
              "checks": outcome})
        return [name for name, got in outcome.items() if got == "passed"]
    return counts


# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _state_tensors(state):
    from dlrover_tpu_torch.convert import named_leaves

    return [(name, _local(x)) for name, x in named_leaves(state)
            if isinstance(x, torch.Tensor)]


def _state_bytes(state):
    return sum(t.numel() * t.element_size() for _, t in _state_tensors(state))


def _unequal_leaves(state, saved):
    return [name for (name, t), s in zip(_state_tensors(state), saved)
            if not torch.equal(t, s)]


def _first_layers(state, n_layers):
    """The state cut to its first ``n_layers`` layers (copies)."""
    def cut(tree, path=()):
        if isinstance(tree, dict):
            return {k: cut(v, path + (k,)) for k, v in tree.items()}
        return tree[:n_layers].clone() if "layers" in path else tree
    return cut(state)


# phase 5 runs on the train phase's first 4 layers: its copies, drains,
# storage writes and restores scale with the state (9.7 GB, not 16.8)
CKPT_LAYERS = 4


def ckpt_phase(trained, device, ckpt_root):
    """Flash Checkpoint on the train phase's state (see the module
    docstring, phase 5). Returns the launches of its two train steps."""
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.parallel.mesh import build_mesh
    from dlrover_tpu_torch.parallel.sharding import shard_tree

    ctx = worker.init(device=device.type)  # NCCL (gloo on the CPU), 1 rank
    c, trainer = trained["config"], trained["trainer"]
    rng = np.random.default_rng(SEED + 5)
    batches = [rng.integers(0, c.vocab_size, trained["batch_shape"],
                            dtype=np.int32) for _ in range(2)]
    state = trained["state"]
    shm_free = shutil.disk_usage("/dev/shm").free
    disk_free = shutil.disk_usage(ckpt_root).free
    full_bytes = _state_bytes(state)
    per_layer = sum(t.numel() * t.element_size()
                    for name, t in _state_tensors(state)
                    if "['layers']" in name) // c.n_layers
    fixed = full_bytes - per_layer * c.n_layers
    room = min(shm_free, disk_free) * 0.9
    layers = min(c.n_layers, CKPT_LAYERS)
    while layers > 1 and fixed + per_layer * layers > room:
        layers -= 1
    if layers != c.n_layers:
        state = _first_layers(state, layers)
        c = dataclasses.replace(c, n_layers=layers)
        trainer._loss_fn = lambda p, t, c=c: llama.next_token_loss(p, t, c)
        torch.cuda.empty_cache()
    emit({"phase": "ckpt_space", "dev_shm_free_bytes": shm_free,
          "storage_free_bytes": disk_free, "storage_dir": ckpt_root,
          "state_bytes_8_layers": full_bytes, "layers": layers,
          "cut_for_space": layers < min(trained["config"].n_layers,
                                        CKPT_LAYERS)})
    # the state as DTensors on a mesh of 1 (same storage, no copy)
    mesh = build_mesh(plan_mesh(1), device.type)
    axes = llama.param_logical_axes(c)
    state = {**state,
             "params": shard_tree(mesh, state["params"], axes),
             "opt_state": {**state["opt_state"],
                           "mu": shard_tree(mesh, state["opt_state"]["mu"],
                                            axes),
                           "nu": shard_tree(mesh, state["opt_state"]["nu"],
                                            axes)}}
    nbytes = _state_bytes(state)
    engine = CheckpointEngine(
        os.path.join(ckpt_root, "ckpt"), job_name=f"chipsmoke{os.getpid()}",
        node_rank=0, local_rank=0, rank=0, world_size=1,
        local_world_size=1, ipc_socket="/nonexistent")
    from dlrover_tpu_torch.observability.memory import get_accountant

    acct = get_accountant()
    shm_key = f"ckpt_shm/{engine._shm.name}"
    mapped = {}
    try:
        counts = _ckpt_checks(engine, state, trainer, batches, device,
                              nbytes, trained["step_s"], ctx, mapped)
    finally:
        engine._shm.unlink()
    # the frames' segment is its staging claim at its mapped size, and
    # none once it is released
    claim, size = mapped.get("claim"), mapped.get("size")
    released = ledger_claims(acct, "staging").get(shm_key, 0)
    emit({"phase": "ckpt_ledger", "shm_segment_bytes": size,
          "staging_claim": claim, "staging_claim_after_release": released,
          "state_bytes": nbytes})
    if claim != size or released != 0:
        raise AssertionError(f"ckpt: staging claim {claim} for a {size}-"
                             f"byte segment, {released} after release")
    return counts


def _ckpt_checks(engine, state, trainer, batches, device, nbytes,
                 step_s_train, ctx, mapped):
    gb = nbytes / 1e9
    # warm: the first save creates and populates the shm segment
    _sync(device)
    t0 = time.perf_counter()
    if not engine.save_to_memory(0, state) or not engine.wait_drained():
        raise AssertionError("ckpt: warm-up save failed")
    cold = dict(engine.last_save, wall_s=time.perf_counter() - t0)
    from dlrover_tpu_torch.observability.memory import get_accountant

    mapped.update(size=engine._shm._shm.size, claim=ledger_claims(
        get_accountant(), "staging").get(f"ckpt_shm/{engine._shm.name}"))
    saved = [t.clone() for _, t in _state_tensors(state)]
    step0 = int(state["step"])
    _sync(device)

    fa.reset_launch_counts()
    # a memory save, then at once a step that writes the state in place
    t0 = time.perf_counter()
    if not engine.save_to_memory(step0, state):
        raise AssertionError("ckpt: save_to_memory skipped")
    pause_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, res = trainer.train_step(state, batches[0])
    loss_in_flight = float(res.loss)
    step_with_save_s = time.perf_counter() - t0
    if not engine.wait_drained():
        raise AssertionError("ckpt: drain failed")
    drain = dict(engine.last_save)
    moved = _unequal_leaves(state, saved)
    if "['params']['lm_head']" not in moved:
        raise AssertionError(f"ckpt: the step left lm_head as it was "
                             f"({moved})")
    # restore from shm over the stepped state: the pre-step values
    state, step = engine.load(state)
    shm_restore = dict(engine.last_restore)
    bad = _unequal_leaves(state, saved)
    if step != step0 or shm_restore["medium"] != "shm" or bad:
        raise AssertionError(f"ckpt: shm restore step {step} "
                             f"{shm_restore}, leaves differ: {bad}")
    if not engine.save_to_storage(step0, state):
        raise AssertionError("ckpt: save_to_storage skipped")
    storage = dict(engine.last_save)
    # a step with no save in flight, then restore from storage over it
    _sync(device)
    t0 = time.perf_counter()
    state, res = trainer.train_step(state, batches[1])
    float(res.loss)
    step_without_save_s = time.perf_counter() - t0
    counts = _launches()
    engine._shm.unlink()
    state, step = engine.load(state)
    storage_restore = dict(engine.last_restore)
    bad = _unequal_leaves(state, saved)
    if step != step0 or storage_restore["medium"] != "storage" or bad:
        raise AssertionError(f"ckpt: storage restore step {step} "
                             f"{storage_restore}, leaves differ: {bad}")
    persist_s = storage["storage_s"] - storage["drain_s"]
    emit(dict(
        phase="ckpt", state_bytes=nbytes, leaves=len(saved),
        world_size=ctx.world_size, launches=counts,
        save_pause_ms=pause_s * 1e3,
        drain_s=drain["drain_s"], drain_gb_per_s=gb / drain["drain_s"],
        cold_drain_s=cold["drain_s"],
        cold_drain_gb_per_s=gb / cold["drain_s"],
        storage_persist_s=persist_s, storage_gb_per_s=gb / persist_s,
        storage_save_s=storage["storage_s"],
        restore_shm_s=shm_restore["seconds"],
        restore_shm_gb_per_s=gb / shm_restore["seconds"],
        restore_storage_s=storage_restore["seconds"],
        restore_storage_gb_per_s=gb / storage_restore["seconds"],
        step_s_with_save_in_flight=step_with_save_s,
        step_s_without_save=step_without_save_s,
        step_s_train_phase=step_s_train,
        loss_with_save_in_flight=loss_in_flight,
        snapshot_holds_pre_step_values=True, restores_bitwise=True,
    ))
    del saved
    return counts


def resume_child(args) -> int:
    """One run of the twin's ``train`` (a child of :func:`resume_phase`)."""
    spec = importlib.util.spec_from_file_location(
        "llama_elastic_pretrain_torch",
        os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = llama.LlamaConfig(**{
        k: (getattr(torch, v) if k == "dtype" else v)
        for k, v in args["config"].items()})
    ctx = worker.init(device=device.type)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    step_s = {}

    def on_step(step, loss):
        step_s[step] = time.perf_counter() - t0

    out = twin.train(config, args["steps"], args["global_batch"],
                     args["seq"], args["ckpt_dir"], ctx,
                     ckpt_every=args["storage_every"],
                     kill_at_step=args.get("kill_at"), on_step=on_step)
    engine = out["checkpointer"].engine
    print("RESUME " + json.dumps(dict(
        start_step=out["start_step"], restored_from=out["restored_from"],
        restore=engine.last_restore, losses=out["losses"],
        grad_norms=out["grad_norms"], step_s=step_s,
        launches=_launches(), seconds=time.perf_counter() - t0,
        last_save=engine.last_save)), flush=True)
    worker.shutdown()
    return 0


# phase 8: the faults of the drill, keyed on the incarnation (the agent's
# restart count), never on the step alone: the first incarnation is killed
# once step 3's memory frame is sealed; the second tears its step-6 frame
# (the injector) and is killed after it, waiting at its storage step until
# storage holds that step (so the step-6 frame is not skipped as busy);
# the third wedges the card after step 8, outside the training span; the
# fourth, once the agent's replica store holds its step-9 frame, unlinks
# its own segment and SIGKILLs itself
ELASTIC_PLAN = {0: ("kill", 3), 1: ("kill", 6), 2: ("hang", 8),
                3: ("unlink_kill", 9)}
# the incarnations whose restore the store's copy of the killed step
# decides (the torn frame's, refused; the unlinked frame's, written back):
# they wait for the store to hold that step before the kill, the push of
# the step before waited out so the kill step's is not skipped as busy
ELASTIC_STORE_WAIT = (1, 3)
# the device timer's hang timeout in phase 8: below the hang rule's
# downtime, so the gauge is up in the beats before the stall counts
ELASTIC_HANG_TIMEOUT_S = 10.0
ELASTIC_TORN_SCHEDULE = "shm.write:torn@step=6"
# an agent-side fault: every commit of the agent's saver waits 10 ms, and
# the agent's flight recorder (cooldown 0) captures a chaos bundle at each
ELASTIC_AGENT_FAULT = "storage.commit:delay=10ms"
# the first incarnation's worker: a forced memory-pressure breach at its
# first memory sweep (the journal event, and a bundle with memory.json)
ELASTIC_MEM_SCHEDULE = "mem.pressure:error@times=1"


def _optel_vs_metrics():
    """This worker's op-telemetry compute count and the compute count of
    the mm family its device-timer endpoint serves (the kernels
    ``classify`` puts in compute), once the hook's events drained."""
    import urllib.request

    from dlrover_tpu_torch.common.constants import (
        ConfigKey,
        EnvKey,
        env_int,
    )
    from dlrover_tpu_torch.observability.op_telemetry import classify
    from dlrover_tpu_torch.observability.tpu_timer import (
        DEFAULT_WORKER_PORT_BASE,
        KIND_MM,
        get_timer,
    )

    timer = get_timer()
    timer.wait_drained()
    snap = timer.op_telemetry()
    port = (env_int(ConfigKey.TPU_TIMER_PORT, DEFAULT_WORKER_PORT_BASE)
            + env_int(EnvKey.LOCAL_RANK, 0))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        text = resp.read().decode()
    mm = 0
    for ln in text.splitlines():
        if ln.startswith("XPU_TIMER_MM_KERNEL_COUNT{"):
            kernel = ln.split('kernel="', 1)[1].split('"', 1)[0]
            # the GC hook's pauses ride the mm family but no op class
            if kernel != "py_gc" and classify(KIND_MM, kernel) == "compute":
                mm += int(float(ln.rsplit(" ", 1)[1]))
    return dict(compute_n=snap["classes"].get("compute", {}).get("n", 0),
                seq=snap["seq"], mm_compute=mm)


def elastic_child(args) -> int:
    """One incarnation of the twin under the port's agent (phase 8): its
    steps, losses and launches as ``STEP`` lines, its restore as a
    ``START`` line, its fault as the twin's kill line or a ``WEDGE``
    line."""
    from dlrover_tpu_torch.ckpt.ckpt_saver import latest_step
    from dlrover_tpu_torch.common.constants import EnvKey, env_int

    restart = env_int(EnvKey.RESTART_COUNT, 0)
    if restart == 0:
        # the memory-pressure breach is the first incarnation's fault
        os.environ["DLROVER_FAULT_SCHEDULE"] = ELASTIC_MEM_SCHEDULE
    elif restart != 1:
        # the torn frame is the second incarnation's fault alone
        os.environ.pop("DLROVER_FAULT_SCHEDULE", None)
    spec = importlib.util.spec_from_file_location(
        "llama_elastic_pretrain_torch",
        os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = llama.LlamaConfig(**{
        k: (getattr(torch, v) if k == "dtype" else v)
        for k, v in args["config"].items()})
    ctx = worker.init(device=device.type)
    fa.reset_launch_counts()
    kind, at = ELASTIC_PLAN.get(restart, (None, None))

    def emit_line(tag, **data):
        _say(tag, dict(restart=restart, t=time.time(), **data))

    engine = []
    from dlrover_tpu_torch.observability import tracing

    traced = set()

    def ckpt_traces():
        """The persist requests this incarnation traced since the last
        call: [step, trace_id] each."""
        out = []
        for sp in tracing.get_tracer().finished_spans():
            if (sp.name == "ckpt.persist_request"
                    and sp.span_id not in traced):
                traced.add(sp.span_id)
                out.append([sp.attrs.get("step"), sp.trace_id])
        return out

    spent = {}

    def timed(obj, name):
        """Sum the seconds of ``obj.name``'s calls into ``spent``."""
        fn = getattr(obj, name)

        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] = (spent.get(name, 0.0)
                               + time.perf_counter() - t0)

        setattr(obj, name, call)

    def on_start(start_step, ckpt, trainer):
        from dlrover_tpu_torch.common import state_fence

        engine.append(ckpt.engine)
        # a step's parts: its train step, the optimizer's wait (inside it)
        # for the last save's device-to-host copy, its save (the save lock
        # and the frame's registration cross the agent's IPC) and its
        # progress calls to the agent
        for obj, name in ((trainer, "train_step"),
                          (state_fence, "wait_readers"),
                          (ckpt, "save_checkpoint"),
                          (ctx, "publish_step"), (ctx, "report_step")):
            timed(obj, name)
        emit_line("START", start_step=start_step, pid=os.getpid(),
                  restore=ckpt.engine.last_restore,
                  grad_accum=trainer.grad_accum_steps,
                  **_start_of_script())
        # the model is built and restored: everything is imported by now
        emit_line("MODULES", forbidden=sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu")))

    prev_end = []

    def on_step(step, loss):
        replicas = engine[0].replicas
        # the step's own time: from the end of the previous on_step (its
        # waits left out) to here, the save's non-blocking part included
        emit_line("STEP", step=step, loss=float(loss),
                  launches=_launches(), ckpt_traces=ckpt_traces(),
                  push=replicas.last_push if replicas else None,
                  work_s=time.time() - prev_end[0] if prev_end else None,
                  parts=dict(spent),
                  saved=engine[0].last_save.get("step") == step,
                  last_save=dict(engine[0].last_save))
        # the op telemetry this step's publish will carry, beside the mm
        # family's compute count on this worker's device-timer /metrics:
        # both from the one native engine, read once its events drained
        emit_line("OPTEL", step=step, **_optel_vs_metrics())
        if restart in ELASTIC_STORE_WAIT and replicas is not None:
            if step + 1 == at:
                # the drain ends with the store's copy
                engine[0].wait_drained()
            elif step == at:
                # the fault waits on the store's step, not on the seal
                engine[0].wait_drained()
                stored = _await_stored(replicas, engine[0].local_rank,
                                       step)
                emit_line("STORED", step=step, stored=stored,
                          push=replicas.last_push)
        if kind == "unlink_kill" and step == at:
            # the incarnation's one step reaches the agent (its recovery
            # closes before this fault opens one); the segment goes next:
            # the restore cannot come from shm, and the agent's breakpoint
            # save finds no frame of this step
            ctx.publish_step(step)
            engine[0]._shm.unlink()
            print(json.dumps({"killed_at_step": step, "ts": time.time()}),
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        prev_end[:] = [time.time()]
        spent.clear()
        if kind == "hang" and step + 1 == at:
            # the hang restores the wedged step's frame: the drill waits
            # out this drain so that step's save is not skipped as busy
            engine[0].wait_drained()
        if (kind == "kill" and at > step
                and step % args["storage_every"] == 0):
            deadline = time.monotonic() + 300
            while (latest_step(args["ckpt_dir"]) < step
                   and time.monotonic() < deadline):
                time.sleep(0.05)

    steps = at if kind == "hang" else args["steps"]
    twin.train(config, steps, args["global_batch"], args["seq"],
               args["ckpt_dir"], ctx, ckpt_every=args["storage_every"],
               kill_at_step=at if kind == "kill" else None,
               on_step=on_step, on_start=on_start)
    if kind == "hang":
        emit_line("WEDGE", step=at)
        # until the hang rule's restart kills this worker
        if device.type == "cuda":
            # a device wedge: the card spins past the drill's end, and a
            # hooked GEMM (and the copy of its sum) queued behind the spin
            # never starts, so the device timer's watchdog raises the hang
            # gauge the agent's beats carry
            w = torch.ones(256, 256, device=device, dtype=torch.bfloat16)
            (w @ w).float().sum().item()  # its kernels loaded first
            torch.cuda._sleep(1 << 60)
            (w @ w).float().sum().item()
        else:
            # on the CPU (a rehearsal) a host bracket that never ends
            from dlrover_tpu_torch.observability.tpu_timer import (
                KIND_COLL,
                get_timer,
            )

            with get_timer().span("wedged_step", kind=KIND_COLL):
                time.sleep(3600)
    worker.shutdown()
    return 0


def _say(tag, obj):
    """One ``TAG {json}`` line in one write: the ranks of a node share
    their agent's stdout, and a line written in pieces interleaves."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(),
             f"{tag} {json.dumps(obj)}\n".encode())


def _start_of_script():
    """How this worker process started: from a warm spare (torch imported
    before the script's first line) with its spawn, pre-import and release
    times, or cold; the seconds from release (warm) to the script's first
    line; and whether torch held a CUDA context at that line."""
    from dlrover_tpu_torch.common.constants import ConfigKey

    spare = os.environ.get(ConfigKey.WARM_SPARE)
    out = dict(warm=_WARM_START, script_t0=_SCRIPT_T0, spare=None)
    if spare:
        spawn, import_s, release = (float(x) for x in spare.split(","))
        out["spare"] = dict(spawn=spawn, import_s=import_s, release=release,
                            release_to_script_s=_SCRIPT_T0 - release)
    out["cuda_at_first_line"] = bool(_CUDA_AT_FIRST_LINE)
    return out


def _await_stored(replicas, local_rank, step, timeout=600):
    """The newest step of this worker's own frame in the stores, waited
    (bounded) until it reaches ``step``."""
    deadline = time.monotonic() + timeout
    while True:
        mine = max((s for o, lr, s in replicas.list_entries()
                    if (o, lr) == (replicas.node_rank, local_rank)),
                   default=-1)
        if mine >= step or time.monotonic() > deadline:
            return mine
        time.sleep(0.05)


def node_child(args) -> int:
    """One worker of the node drill (``--multi``): the twin at a fixed
    micro batch of 1 a replica, so a smaller world takes more
    accumulation steps; its restore as a ``START`` line and, on rank 0 of
    the world, its steps as ``STEP`` lines."""
    from dlrover_tpu_torch.common.constants import EnvKey, env_int

    spec = importlib.util.spec_from_file_location(
        "llama_elastic_pretrain_torch",
        os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = llama.LlamaConfig(**{
        k: (getattr(torch, v) if k == "dtype" else v)
        for k, v in args["config"].items()})
    ctx = worker.init(device=device.type)
    fa.reset_launch_counts()
    restart = env_int(EnvKey.RESTART_COUNT, 0)
    node = env_int(EnvKey.NODE_RANK, 0)

    def emit_line(tag, **data):
        _say(tag, dict(node=node, restart=restart, rank=ctx.rank,
                       world=ctx.world_size, t=time.time(), **data))

    engine = []

    def on_start(start_step, ckpt, trainer):
        # every rank reports its restore
        engine.append(ckpt.engine)
        emit_line("START", start_step=start_step,
                  restore=ckpt.engine.last_restore,
                  grad_accum=trainer.grad_accum_steps, **_start_of_script())

    def on_step(step, loss):
        if ctx.rank == 0:
            replicas = engine[0].replicas
            emit_line("STEP", step=step, loss=float(loss),
                      launches=_launches(),
                      push=replicas.last_push if replicas else None)
        # pace the drill: the kill lands while the full world trains, and
        # the returning node joins while the small world has steps left
        time.sleep(args["pace_s"])

    twin.train(config, args["steps"], args["global_batch"], args["seq"],
               args["ckpt_dir"], ctx, ckpt_every=args["storage_every"],
               on_step=on_step, on_start=on_start,
               micro_batch_per_replica=1)
    worker.shutdown()
    return 0


ELASTIC_AGENT = (
    "import sys\n"
    "from dlrover_tpu_torch.agent import run\n"
    "code = run.main(sys.argv[1:])\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'dlrover_tpu'))\n"
    "print('AGENT_MODULES ' + ','.join(bad), flush=True)\n"
    "sys.exit(code or (3 if bad else 0))\n"
)


def _lines(text, tag):
    """The JSON objects of a log's ``TAG {...}`` lines; a line another
    process wrote into is skipped."""
    out = []
    for ln in text.splitlines():
        if ln.startswith(tag + " "):
            try:
                out.append(json.JSONDecoder().raw_decode(
                    ln, len(tag) + 1)[0])
            except ValueError:
                continue
    return out


def _ckpt_arc(bundle_dir, step_lines):
    """The agent's chaos bundles (phase 8's ``storage.commit`` delay: the
    first one's digest and their count) and the checkpoint arcs they share
    with the workers: the persist requests the workers traced whose
    trace_id the saver's ``ckpt.persist`` or ``ckpt.commit`` spans in a
    bundle carry."""
    out = {"chaos_bundle": None, "shared": []}
    names = sorted((n for n in (os.listdir(bundle_dir)
                                if os.path.isdir(bundle_dir) else [])
                    if n.startswith("bundle_agent_0_chaos_fault_")),
                   key=lambda n: int(n.split("_")[-2]))
    if not names:
        return out
    with open(os.path.join(bundle_dir, names[0], "manifest.json")) as f:
        manifest = json.load(f)
    out["chaos_bundle"] = dict(name=names[0], bundles=len(names),
                               fault_site=manifest.get("fault_site"),
                               fault_kind=manifest.get("fault_kind"),
                               files=sorted(manifest.get("files", [])),
                               spans=manifest.get("spans_finished", 0)
                               + manifest.get("spans_live", 0))
    saver = {}
    for name in names:
        for tid, span, _, _, _ in _bundle_spans(
                os.path.join(bundle_dir, name)):
            if span in ("ckpt.persist", "ckpt.commit"):
                saver.setdefault(tid, set()).add(span)
    for r in step_lines:
        for step, tid in r.get("ckpt_traces", []):
            if tid in saver:
                out["shared"].append(dict(
                    trace_id=tid, step=step, restart=r["restart"],
                    worker="ckpt.persist_request",
                    saver=sorted(saver[tid])))
    return out


def _median_step_s(runs, storage_every):
    """The step time: the median gap between consecutive step reports
    over ``runs`` (each ``{step: seconds}``, one process each), leaving
    out a run's first gap (its second step still warms up) and gaps that
    end at a storage step (the save's wait); memory saves included."""
    gaps = []
    for steps in runs:
        order = sorted(steps, key=int)
        gaps += [steps[b] - steps[a]
                 for a, b in zip(order[1:], order[2:])
                 if int(b) % storage_every]
    return float(np.median(gaps)) if gaps else None


def _steady_train_step_s(step_lines):
    """The median ``train_step`` of the steps that neither start their
    incarnation (warm-up) nor wait for a save's device-to-host copy (the
    step after an incarnation's first save waits seconds for its cold
    drain, with or without replicas): the step's own compute beside the
    agent's copies; None when no step qualifies."""
    first = {}
    for r in step_lines:
        first.setdefault(r["restart"], r["step"])
    got = [r["parts"]["train_step"] for r in step_lines
           if r.get("parts") and r["step"] != first[r["restart"]]
           and r["parts"].get("wait_readers", 0.0) < 0.05
           and "train_step" in r["parts"]]
    return float(np.median(got)) if got else None


def _timer_evidence(text, wedge_t):
    """What the agent's log says of the device timer around the wedge:
    the gauge's rise in its beats, the master's vote, the stack dump and
    the profile request."""
    import re

    rise = re.search(r"hang gauge XPU_TIMER_COMMON_HANG=1 at t=([0-9.]+), "
                     r"beat carries (\d+) non-zero", text)
    stack = re.search(r"worker stacks saved to (\S+)", text)
    stacks = []
    if stack and os.path.exists(stack.group(1)):
        with open(stack.group(1)) as f:
            stacks = json.load(f)
        os.remove(stack.group(1))
    return dict(
        gauge_rise_s=(float(rise.group(1)) - wedge_t
                      if rise and wedge_t else None),
        mm_gauges_in_beat=int(rise.group(2)) if rise else 0,
        voted_training_hang=("training hang detected (hang gauge votes "
                             "from nodes [0])" in text),
        step_stall_events=text.count("diagnosis event step_stall"),
        stack_dump=stack.group(1) if stack else None,
        stack_pids=[st.get("pid") for st in stacks],
        python_stack_has_wedge=any("elastic_child" in st.get("python", "")
                                   for st in stacks),
        profile_requested="torch.profiler traces from 1 workers" in text)


def _step_gaps(result):
    """Gaps between consecutive step reports of one run, the first from
    the run's start (model build and restore included)."""
    times = [0.0] + [result["step_s"][k]
                     for k in sorted(result["step_s"], key=int)]
    return [b - a for a, b in zip(times, times[1:])]


def elastic_phase(config, device, ckpt_root, global_batch, seq, steps,
                  storage_every, reference, hang_downtime_s, timeout=900):
    """The twin under the port's ``dlrover-run`` with three faults (module
    docstring, phase 8). ``reference``: the unkilled run's losses and the
    spread of two unkilled runs. Returns the launches of every
    incarnation."""
    from dlrover_tpu_torch.ckpt import manifest
    from dlrover_tpu_torch.common.event import (
        AgentEvent,
        compute_goodput,
        load_events,
    )
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory
    from dlrover_tpu_torch.common.rpc import find_free_port

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    job = f"el{os.getpid()}"
    ckpt_dir = os.path.join(ckpt_root, job)
    event_dir = os.path.join(ckpt_root, f"{job}_events")
    bundle_dir = os.path.join(ckpt_root, f"{job}_bundles")
    os.makedirs(event_dir)
    args = dict(device=str(device), config=cfg, steps=steps,
                global_batch=global_batch, seq=seq,
                storage_every=storage_every, ckpt_dir=ckpt_dir)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_")}
    if ELASTIC_HANG_TIMEOUT_S >= hang_downtime_s:
        raise AssertionError(
            f"elastic: the timer's hang timeout {ELASTIC_HANG_TIMEOUT_S} s "
            f"is not below the hang rule's downtime {hang_downtime_s} s")
    env.update({
        "PYTHONPATH": REPO,
        "TPU_TIMER_HANG_TIMEOUT": str(ELASTIC_HANG_TIMEOUT_S),
        "TPU_TIMER_DAEMON_PORT": str(find_free_port("127.0.0.1")),
        "TPU_TIMER_PORT": str(find_free_port("127.0.0.1")),
        "DLROVER_TPU_PROFILE_DIR": os.path.join(ckpt_root,
                                                f"{job}_profiles"),
        "DLROVER_TPU_EVENT_DIR": event_dir,
        "DLROVER_TPU_HEARTBEAT_INTERVAL_S": "1",
        "DLROVER_TPU_HANG_RESTART_WORKERS": "1",
        "DLROVER_TPU_HANG_DOWNTIME_S": str(hang_downtime_s),
        "DLROVER_TPU_DIAGNOSIS_INTERVAL_S": "1",
        "DLROVER_FAULT_SCHEDULE": (ELASTIC_TORN_SCHEDULE + ";"
                                   + ELASTIC_AGENT_FAULT),
        "DLROVER_TPU_TRACE_DIR": bundle_dir,
        "DLROVER_TPU_TRACE_BUNDLE_COOLDOWN_S": "0",
    })
    # the standalone master's HTTP routes, read while the run lasts
    master_http = f"127.0.0.1:{find_free_port('127.0.0.1')}"
    env["DLROVER_TPU_HTTP_PORT"] = master_http.rsplit(":", 1)[1]
    log_path = os.path.join(ckpt_root, f"{job}.log")
    t0 = time.time()
    scraped, card_pids = {}, {}
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", ELASTIC_AGENT, "--standalone",
             "--nproc-per-node=1", "--max-restarts=4",
             "--save-at-breakpoint", "--monitor-interval=0.1",
             "--tpu-timer", "--ckpt-replica=2", f"--job_name={job}",
             f"--ckpt_dir={ckpt_dir}", os.path.abspath(__file__),
             "--elastic-child", json.dumps(args)],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, start_new_session=True)
        try:
            deadline = time.monotonic() + timeout
            while proc.poll() is None and time.monotonic() < deadline:
                _scrape_master(master_http, scraped)
                if device.type == "cuda":
                    _card_pids(card_pids)
                time.sleep(1.0)
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall_s = time.time() - t0
    with open(log_path) as f:
        text = f.read()
    os.remove(log_path)
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrtpu_{job}_"):
            unlink_shared_memory(name)
    records = []
    for i, name in enumerate(sorted(os.listdir(event_dir))):
        for r in load_events(os.path.join(event_dir, name)):
            records.append(dict(r, event_id=(i, r.get("event_id"))))
    agent = [r for r in records if r["target"] == "agent_0"]
    stored = sorted(s for s in range(steps + 1)
                    if manifest.manifest_links(ckpt_dir, s))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(event_dir, ignore_errors=True)
    starts = {r["restart"]: r for r in _lines(text, "START")}
    step_lines = _lines(text, "STEP")
    arc = _ckpt_arc(bundle_dir, step_lines)
    attribution = _attribution_checks(scraped, bundle_dir, ckpt_root, job,
                                      _lines(text, "OPTEL"), text)
    shutil.rmtree(bundle_dir, ignore_errors=True)
    kills = {r["killed_at_step"]: r["ts"] for r in
             (json.loads(ln) for ln in text.splitlines()
              if ln.startswith('{"killed_at_step"'))}
    wedges = _lines(text, "WEDGE")
    timer = _timer_evidence(text, wedges[0]["t"] if wedges else None)
    shutil.rmtree(os.path.join(ckpt_root, f"{job}_profiles"),
                  ignore_errors=True)
    for pid in {*(r.get("pid") for r in starts.values()),
                *timer["stack_pids"]}:
        for name in (f"tpu_timer_pystack_{pid}.txt",
                     f"tpu_timer_hang_{pid}.txt"):
            if os.path.exists(os.path.join("/tmp", name)):
                os.remove(os.path.join("/tmp", name))
    modules = _lines(text, "MODULES")
    agent_modules = [ln for ln in text.splitlines()
                     if ln.startswith("AGENT_MODULES")]
    fails = [r for r in agent if r["name"] == AgentEvent.WORKER_FAIL]
    restarts = [r for r in agent if r["name"] == AgentEvent.RESTART]
    spawns = [r for r in agent if r["name"] == AgentEvent.WORKER_SPAWN]
    rounds = [r["content"]["round"] for r in agent
              if r["name"] == AgentEvent.RENDEZVOUS and r["phase"] == "END"]
    bp_saves = [r["content"] for r in agent
                if r["name"] == AgentEvent.CKPT_SAVE and r["phase"] == "END"]
    losses, launches, first_step, step_t = {}, {}, {}, {}
    for r in step_lines:  # in order: a later incarnation's step wins
        losses[r["step"]] = r["loss"]
        launches[r["restart"]] = r["launches"]
        first_step.setdefault(r["restart"], r["t"])
        step_t.setdefault(r["restart"], {})[r["step"]] = r["t"]
    # the steps' own times, under the pushes: the kill steps (waited
    # drains) and the storage steps left out
    work_rows = [r for r in step_lines if r.get("work_s")
                 and r["step"] % storage_every and r["step"] not in kills]
    work = [r["work_s"] for r in work_rows]
    # the medians of those steps' parts (the rest: the loader and the
    # loss's sync), and how many of them saved (the others skipped, the
    # drain and the store's copy still running)
    parts = {k: float(np.median([r["parts"].get(k, 0.0)
                                 for r in work_rows]))
             for k in ("train_step", "wait_readers", "save_checkpoint",
                       "publish_step", "report_step")} if work_rows else {}
    # every step's own time and parts, the save it made or skipped, and
    # the newest save's drain (a first save in a process drains cold)
    step_rows = [dict(restart=r["restart"], step=r["step"],
                      work_s=r.get("work_s"), parts=r.get("parts"),
                      saved=r.get("saved"), last_save=r.get("last_save"))
                 for r in step_lines]
    timer.update(step_s_timer=_median_step_s(step_t.values(),
                                             storage_every),
                 step_s_phase6=reference.get("step_s"),
                 work_step_s=float(np.median(work)) if work else None,
                 work_steps=len(work), work_parts_s=parts,
                 steady_train_step_s=_steady_train_step_s(step_lines),
                 steps=step_rows,
                 work_steps_saved=sum(bool(r.get("saved"))
                                      for r in work_rows),
                 hang_timeout_s=ELASTIC_HANG_TIMEOUT_S)

    def fault(restart, t_fault, acted):
        nxt = starts.get(restart + 1, {})
        restore = nxt.get("restore", {})
        return dict(
            detect_s=(acted - t_fault) if acted else None,
            restart_s=(first_step[restart + 1] - t_fault
                       if restart + 1 in first_step else None),
            medium=restore.get("medium"), step=restore.get("step"),
            restore_s=restore.get("seconds"),
            restore_gb_per_s=(restore["bytes"] / restore["seconds"] / 1e9
                              if restore.get("seconds") else None))

    faults = {
        "kill_after_3": fault(0, kills.get(3), fails[0]["ts"]
                              if fails else None),
        "torn_6_kill_after_6": fault(1, kills.get(6), fails[1]["ts"]
                                     if len(fails) > 1 else None),
        "hang_after_8": fault(
            2, wedges[0]["t"] if wedges else None,
            next((r["ts"] for r in restarts
                  if "diagnosis action" in r["content"]["reason"]), None)),
        "unlink_kill_after_9": fault(3, kills.get(9), fails[2]["ts"]
                                     if len(fails) > 2 else None),
    }
    written_back = starts.get(4, {}).get("restore", {}).get("written_back")
    stored_lines = {r["restart"]: r for r in _lines(text, "STORED")}
    spares = _spare_rows(starts, spawns, card_pids, os.getpid())
    pushes = _push_rows(step_lines)
    startup_s = {sp["content"]["restart_count"]:
                 first_step.get(sp["content"]["restart_count"], 0) - sp["ts"]
                 for sp in spawns}
    goodput = compute_goodput(records)
    want = reference["losses"]
    worst = max(abs(losses.get(s, float("nan")) - want[s]) / abs(want[s])
                for s in want)
    per_run = [launches.get(r, {}) for r in range(5)]
    expect = {"kill_after_3": ("shm", 3), "torn_6_kill_after_6":
              ("storage", 5), "hang_after_8": ("shm", 8),
              "unlink_kill_after_9": ("shm", 9)}
    problems = []
    if rc != 0:
        problems.append(f"the agent exited {rc}")
    if len(spawns) != 5 or len(fails) != 3:
        problems.append(f"{len(spawns)} spawns, {len(fails)} failures")
    for name, (medium, step) in expect.items():
        if (faults[name]["medium"], faults[name]["step"]) != (medium, step):
            problems.append(f"{name} restored {faults[name]}")
    # the fourth fault's frame came back from the agent's store, and the
    # store held the killed steps (the torn copy of 6 refused by its CRCs)
    if written_back != "replica":
        problems.append(f"step 9 was not written back from the replica "
                        f"store: {starts.get(4, {}).get('restore')}")
    if ({r: ln["stored"] for r, ln in stored_lines.items()} != {1: 6, 3: 9}
            or "fails its integrity check" not in text):
        problems.append(f"the store's copies: {stored_lines} (the torn "
                        f"copy refused: {'fails its integrity' in text})")
    if "chaos: injected torn" not in text or (
            "refusing to persist" not in text):
        problems.append("the torn frame was not injected and refused")
    if {6, 9} & set(stored) or not {3, 5, 8} <= set(stored):
        problems.append(f"storage holds steps {stored}")
    if sorted(losses) != list(range(1, steps + 1)) or not (
            worst <= reference["spread"]):
        problems.append(f"losses {losses} vs {want}")
    if (len(modules) != 5 or any(m["forbidden"] for m in modules)
            or agent_modules != ["AGENT_MODULES "]):
        problems.append(f"modules {modules} {agent_modules}")
    # every incarnation from a warm spare, no cold fallback, and no spare
    # on the card (a CUDA context) before its release
    if spares["problems"]:
        problems.append("warm spares: " + "; ".join(spares["problems"]))
    for r, c in enumerate(per_run):
        if not all(c.get(k) for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")):
            problems.append(f"incarnation {r} launches {c}")
    if (arc["chaos_bundle"] is None
            or arc["chaos_bundle"]["fault_site"] != "storage.commit"
            or not arc["shared"]):
        problems.append(f"the agent's chaos bundle and checkpoint arc "
                        f"{arc}")
    # the device timer closed the hang loop: the gauge rode the beats with
    # the GEMM families, the master's verdict was the node's vote, the
    # daemon's stack dump holds the wedged frame, a profile was asked for,
    # and the next incarnation trained on the card the spin held
    if not (timer["gauge_rise_s"] is not None
            and timer["mm_gauges_in_beat"] > 0
            and timer["voted_training_hang"]
            and timer["python_stack_has_wedge"]
            and timer["profile_requested"] and 3 in first_step):
        problems.append(f"the device timer's hang loop: {timer}")
    emit(dict(
        phase="elastic", config=dict(dim=config.dim,
                                     n_layers=config.n_layers,
                                     dtype=cfg["dtype"]),
        global_batch=global_batch, seq_len=seq, steps=steps,
        storage_every=storage_every, hang_downtime_s=hang_downtime_s,
        agent_exit=rc, restarts=len(spawns) - 1, faults=faults,
        step_9_written_back=written_back, store_at_kill=stored_lines,
        spares=spares["rows"], card_pids_seen=spares["card_pids_seen"],
        pushes=pushes, rendezvous_rounds=rounds, startup_s=startup_s,
        breakpoint_saves=bp_saves, storage_steps=stored,
        losses=[losses.get(s) for s in range(1, steps + 1)],
        max_rel_diff_vs_unkilled=worst,
        unkilled_spread=reference["spread"],
        launches_per_incarnation=per_run,
        wall_s=wall_s, goodput_pct=100.0 * goodput["goodput"],
        goodput_wall_s=goodput["wall_s"],
        jax_modules_agent=agent_modules,
        jax_modules_workers=[m["forbidden"] for m in modules],
        agent_chaos_bundle=arc["chaos_bundle"], ckpt_arc=arc["shared"],
        device_timer=timer, attribution=attribution["row"],
        card=_card() if device.type == "cuda" else None))
    problems.extend(attribution["problems"])
    if problems:
        raise AssertionError("elastic: " + "; ".join(problems)
                             + "\n" + text[-6000:])
    return per_run


def copy_probe(nbytes=6_170_000_000, rounds=("bytearray", "numpy", "numpy",
                                            "bytearray")):
    """``--copy-probe``: the replica store's copy of a phase-8-sized frame
    (6.17 GB) out of a ``/dev/shm`` file, by ``preadv`` into a
    ``bytearray`` (zeroed first, under the GIL) or into an unzeroed numpy
    buffer (what ``SharedMemoryHandler.read_frame_bytes`` allocates), with
    a thread beside it that sleeps 1 ms at a time, as the agent's IPC and
    RPC threads wait beside the store's copy: each round's copy seconds
    and the thread's longest wake-up gap (how long the copy held the
    GIL)."""
    import threading

    from dlrover_tpu_torch.ckpt.shm_handler import SharedMemoryHandler

    path = f"/dev/shm/dlrtpu_copyprobe_{os.getpid()}"
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    rows = []
    try:
        block = np.random.default_rng(SEED).integers(
            0, 255, 64 << 20, dtype=np.uint8).tobytes()
        for off in range(0, nbytes, len(block)):
            os.write(fd, block[:nbytes - off])
        del block
        for kind in rounds:
            gaps, stop = [0.0], threading.Event()

            def tick():
                while not stop.is_set():
                    t = time.perf_counter()
                    time.sleep(0.001)
                    gaps[0] = max(gaps[0], time.perf_counter() - t)

            ticker = threading.Thread(target=tick, daemon=True)
            ticker.start()
            time.sleep(0.05)
            t0 = time.perf_counter()
            buf = (bytearray(nbytes) if kind == "bytearray"
                   else memoryview(np.empty(nbytes, np.uint8)))
            alloc_s = time.perf_counter() - t0
            ok = SharedMemoryHandler._preadv_full(fd, buf, 0)
            copy_s = time.perf_counter() - t0
            stop.set()
            ticker.join()
            rows.append(dict(buffer=kind, ok=ok, alloc_s=alloc_s,
                             copy_s=copy_s, gb_per_s=nbytes / copy_s / 1e9,
                             max_tick_gap_s=gaps[0]))
            del buf
            gc.collect()
    finally:
        os.close(fd)
        os.unlink(path)
    emit(dict(phase="copy_probe", bytes=nbytes, rounds=rows, card=_card()))
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"copy_probe: a read failed: {rows}")


def _card_pids(seen):
    """Record the first time each process with a context on the card
    appears in ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout
    except (OSError, subprocess.TimeoutExpired):
        return
    now = time.time()
    for ln in out.split():
        if ln.strip().isdigit():
            seen.setdefault(int(ln), now)


def _spare_rows(starts, spawns, card_pids, parent_pid):
    """Each incarnation's start: warm or cold, the spare's pre-import
    seconds, release (or spawn) to the script's first line, and when its
    pid first held a context on the card. Problems: a cold start or a cold
    spawn event, a context before the release, or a card process that is
    no worker of the run (a spare with a context). ``nvidia-smi`` pids
    are read only when it shows this process (the parent holds a
    context), i.e. when the card's pids are this namespace's."""
    rows, problems = {}, []
    spawn_ts = {sp["content"]["restart_count"]: sp for sp in spawns}
    visible = parent_pid in card_pids
    workers = {r.get("pid") for r in starts.values()}
    for restart, r in sorted(starts.items()):
        spare = r.get("spare") or {}
        sp = spawn_ts.get(restart, {})
        first = card_pids.get(r.get("pid"))
        rows[restart] = dict(
            warm=r.get("warm"), pid=r.get("pid"),
            import_s=spare.get("import_s"),
            release_to_script_s=spare.get("release_to_script_s"),
            spawn_to_script_s=(r["script_t0"] - sp["ts"]
                               if not spare and sp else None),
            on_card_after_release_s=(first - spare["release"]
                                     if first and spare else None),
            cuda_at_first_line=r.get("cuda_at_first_line"))
        if not r.get("warm") or not spare:
            problems.append(f"incarnation {restart} started cold")
        if r.get("cuda_at_first_line"):
            problems.append(f"incarnation {restart}: a CUDA context before "
                            f"the script")
        if sp and sp["content"].get("warm") != [True]:
            problems.append(f"spawn {restart} warm={sp['content'].get('warm')}")
        # nvidia-smi is polled once a second
        if visible and first and spare and first < spare["release"] - 1.5:
            problems.append(f"incarnation {restart}'s spare (pid "
                            f"{r.get('pid')}) was on the card before its "
                            f"release")
    strangers = sorted(set(card_pids) - workers - {parent_pid}) \
        if visible else []
    if strangers:
        problems.append(f"processes on the card that are no worker: "
                        f"{strangers}")
    seen = "visible"
    if not visible and card_pids:
        # another pid namespace: the pids on the card at the first poll
        # are this process's, every later one a worker's; the k-th to
        # appear must not come before the k-th release
        first = min(card_pids.values())
        later = sorted(t for t in card_pids.values() if t > first)
        releases = sorted(r["spare"]["release"] for r in starts.values()
                          if r.get("spare"))
        seen = (f"another namespace: {len(later)} worker pids after "
                f"{len(releases)} releases")
        if len(later) > len(releases) or any(
                t < rel - 1.5 for t, rel in zip(later, releases)):
            problems.append(f"a card process appeared before its release: "
                            f"{later} vs {releases}")
    elif not visible:
        seen = "none listed"
    return {"rows": rows, "problems": problems, "card_pids_seen": seen}


def _push_rows(step_lines):
    """The replica pushes as the workers saw them: each step's newest
    completed push (its step, so the store's lag in steps, and its rate)."""
    rows = []
    for r in step_lines:
        push = r.get("push") or {}
        if push.get("seconds"):
            copy_s = push.get("copy_s")
            rows.append(dict(restart=r["restart"], step=r["step"],
                             pushed_step=push["step"],
                             lag_steps=r["step"] - push["step"],
                             gb_per_s=push["bytes"] / push["seconds"] / 1e9,
                             copy_gb_per_s=(push["bytes"] / copy_s / 1e9
                                            if copy_s else None),
                             bytes=push["bytes"]))
    rates = [p["gb_per_s"] for p in rows]
    copies = [p["copy_gb_per_s"] for p in rows if p["copy_gb_per_s"]]
    lags = [p["lag_steps"] for p in rows]
    return dict(per_step=rows,
                median_gb_per_s=float(np.median(rates)) if rates else None,
                median_copy_gb_per_s=(float(np.median(copies)) if copies
                                      else None),
                max_lag_steps=max(lags) if lags else None)


def _scrape_master(addr, scraped):
    """The standalone master's ``/heartbeats``, ``/memory`` and ``/events``
    into ``scraped`` (the newest answer of each; a route that does not
    answer keeps the last)."""
    for route in ("/heartbeats", "/memory", "/events"):
        try:
            scraped[route] = json.loads(_http_get(addr, route, timeout_s=5.0,
                                                  attempts=1))
        except (OSError, ValueError):
            continue


def _attribution_checks(scraped, bundle_dir, ckpt_root, job, optel, text):
    """Phase 8's attribution plane, from the master's last answers and the
    run's files: every beat that reported a step carried op telemetry and
    a memory ledger; the last beat of each faulted incarnation carried the
    compute count its worker's device-timer /metrics gave at its last
    publish; ``/memory`` names rank 0 on node 0; no straggler or hang
    verdict at world 1; the first incarnation's memory-pressure fault is
    journaled and its bundle holds ``memory.json``, which the report CLI
    renders; and the report CLI prints one incident a fault of the
    journal. Returns ``{"row", "problems"}``."""
    problems, row = [], {}
    beats = scraped.get("/heartbeats", {}).get("0", {})
    # round -1: the beats before the first rendezvous (the agent waits
    # for its warm spares' imports first), no incarnation's
    rounds = {int(k): v for k, v in beats.items() if int(k) >= 0}
    row["beats"] = {r: {k: v for k, v in rec.items()
                        if not k.startswith("last_")}
                    for r, rec in sorted(rounds.items())}
    # a beat reports a step once the agent's progress poll (every 5 s)
    # saw one: the first three faulted incarnations live that long, the
    # last two (one step each) may not
    stepped = [rec for rec in rounds.values() if rec["stepped"]]
    if len(rounds) != 5 or len(stepped) < 3 or any(
            rec["stepped_with_op_telemetry"] != rec["stepped"]
            or rec["stepped_with_memory"] != rec["stepped"]
            for rec in stepped):
        problems.append(f"beats without telemetry: {row['beats']}")
    # every incarnation is one rendezvous round
    by_restart = dict(enumerate(sorted(rounds)))
    kills = {int(json.loads(ln)["killed_at_step"]) for ln in text.splitlines()
             if ln.startswith('{"killed_at_step"')}
    row["last_beat_compute"] = {}
    for restart in (0, 1, 2):
        lines = [r for r in optel if r["restart"] == restart]
        rnd = by_restart.get(restart)
        if not lines or rnd is None:
            problems.append(f"incarnation {restart}: no OPTEL lines or "
                            f"beats")
            continue
        # a killed incarnation's kill step is never published
        published = [r for r in lines if r["step"] not in kills]
        last = max(published, key=lambda r: r["step"])
        snap = rounds[rnd]["last_op_telemetry"].get("0", {})
        got = snap.get("classes", {}).get("compute", {}).get("n")
        row["last_beat_compute"][restart] = dict(
            beat=got, worker=last["compute_n"], metrics=last["mm_compute"],
            step=last["step"])
        if not (got == last["compute_n"] == last["mm_compute"] > 0):
            problems.append(f"incarnation {restart}: last beat's compute "
                            f"{got}, the worker's {last}")
    memory = scraped.get("/memory", {})
    row["memory_ranks"] = {r: {"node_id": v.get("node_id"),
                               "headroom_frac": v.get("headroom_frac"),
                               "categories": v.get("categories")}
                           for r, v in memory.get("ranks", {}).items()}
    if memory.get("ranks", {}).get("0", {}).get("node_id") != 0:
        problems.append(f"/memory does not name rank 0 on node 0: "
                        f"{row['memory_ranks']}")
    journal = scraped.get("/events", {"events": []})
    kinds = [e["kind"] for e in journal["events"]]
    row["journal_kinds"] = {k: kinds.count(k) for k in sorted(set(kinds))}
    if "straggler_detected" in kinds or "hang_attributed" in kinds:
        problems.append(f"a skew verdict at world 1: {row['journal_kinds']}")
    if "memory_pressure" not in kinds:
        problems.append("the memory-pressure fault was not journaled")
    bundles = [n for n in (os.listdir(bundle_dir)
                           if os.path.isdir(bundle_dir) else [])
               if n.startswith("bundle_worker_0_memory_pressure_")]
    journal_path = os.path.join(ckpt_root, f"{job}_journal.json")
    with open(journal_path, "w") as f:
        json.dump(journal, f)
    report = {}
    for name, source in (("bundle", os.path.join(bundle_dir, bundles[0])
                          if bundles else None), ("journal", journal_path)):
        if source is None:
            problems.append("no memory-pressure bundle")
            continue
        r = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.observability.report",
             source], capture_output=True, text=True, timeout=120,
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
        report[name] = dict(rc=r.returncode, text=r.stdout)
    os.remove(journal_path)
    if bundles:
        files = sorted(os.listdir(os.path.join(bundle_dir, bundles[0])))
        row["memory_bundle_files"] = files
        if ("memory.json" not in files or report["bundle"]["rc"] != 0
                or "device memory (HBM ledger at capture):"
                not in report["bundle"]["text"]):
            problems.append(f"the memory bundle {files} and its report "
                            f"{report.get('bundle')}")
    row["report_journal"] = report["journal"]["text"].splitlines()[:8]
    faults = ("killed at 3", "torn 6 and killed", "hang after 8",
              "unlinked and killed at 9")
    if (report["journal"]["rc"] != 0 or not report["journal"]["text"]
            .startswith(f"incident report: {len(faults)} incident(s)")):
        problems.append(f"the report of the journal: {report['journal']}")
    return {"row": row, "problems": problems}


# the straggler leg: steps of the drill (enough that the dump's 3 s profile
# of rank 1 ends while it still steps), and the bf16 GEMMs a step at the
# train step's MLP shape (16384 x 4096 . 4096 x 11008)
STRAGGLER_STEPS = 32
STRAGGLER_MATMULS = 4
STRAGGLER_MM_SHAPE = "16384,4096,11008"


def straggler_phase(device, timeout=240):
    """The straggler drill on the card (module docstring): two port agents
    of one worker each on this card, through
    ``examples/chaos_goodput_torch.py --straggler-only --tpu-timer``."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_")}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "chaos_goodput_torch.py"),
         "--device", device.type, "--straggler-only", "--tpu-timer",
         "--steps", str(STRAGGLER_STEPS), "--step-time", "0",
         "--matmuls", str(STRAGGLER_MATMULS), "--mm-shape",
         STRAGGLER_MM_SHAPE],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    if r.returncode != 0:
        raise AssertionError(f"straggler: the drill exited {r.returncode}:\n"
                             + r.stderr[-6000:])
    res = json.loads(r.stdout.strip().splitlines()[-1])
    s = res["straggler"]
    row = dict(phase="straggler", seconds=time.perf_counter() - t0,
               detect_s=res["straggler_detect_s"], rank=s["rank"],
               cause=s["cause"], ratio=s["ratio"], mean_us=s["mean_us"],
               median_us=s["median_us"],
               skew_ratio_mid=res["skew_ratio_mid"],
               stack_dump=res["stack_dump"], done=res["done"],
               worker_errors=res["worker_errors"],
               steps=STRAGGLER_STEPS, matmuls_per_step=STRAGGLER_MATMULS,
               wall_s=res["wall_s"])
    emit(row)
    problems = []
    if (s["rank"], s["cause"]) != (1, "compute") or not s["ratio"] > 2.0:
        problems.append(f"the verdict {s}")
    if not res["straggler_rank_alive"] or res["verdicts_before_delay"]:
        problems.append("a verdict before the delay, or rank 1 dead")
    dump = res["stack_dump"]
    if not (dump["source"] == "agent_1" and dump["holds_worker_stack"]):
        problems.append(f"the stack dump {dump}")
    # rank 1's profile: taken by its main thread, holding the delayed
    # steps' GEMMs
    if not (dump["profile_ok"] and dump["profile_thread"] == "main"
            and dump["profile_gemm_kernels"] >= STRAGGLER_MATMULS
            and dump["profile_mm_ops"] >= STRAGGLER_MATMULS):
        problems.append(f"rank 1's profile {dump}")
    if not res["skew_ratio_mid"] > 0:
        problems.append(f"the skew gauge {res['skew_ratio_mid']}")
    # every rank's compute class holds the hook's card-timed GEMMs
    for d in res["done"]:
        if (d["hooked_gemms"] != STRAGGLER_MATMULS * STRAGGLER_STEPS
                or d["compute_n"] < d["hooked_gemms"]):
            problems.append(f"rank {d['rank']}: {d}")
    if (len(res["done"]) != 2 or res["forbidden_modules"]
            or res["agent_exit_codes"] != {"0": 0, "1": 0}):
        problems.append(f"done {res['done']}, modules "
                        f"{res['forbidden_modules']}, agents exited "
                        f"{res['agent_exit_codes']}")
    if problems:
        raise AssertionError("straggler: " + "; ".join(problems)
                             + "\n" + r.stderr[-6000:])
    return row


def _run_children(args, job, ranks=1, timeout=900):
    """The twin's ``train`` in ``ranks`` child processes, one rank (and
    card) each, over ``torch.distributed`` when more than one. Returns
    ``[(exit code, output, RESUME result or None)]`` by rank."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env["DLROVER_TPU_JOB_NAME"] = job
    if ranks > 1:
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env.update(DLROVER_TPU_WORLD_SIZE=str(ranks),
                   DLROVER_TPU_LOCAL_WORLD_SIZE=str(ranks),
                   DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}")
    logs, procs = [], []
    for r in range(ranks):
        env.update(DLROVER_TPU_RANK=str(r), DLROVER_TPU_LOCAL_RANK=str(r))
        logs.append(os.path.join(os.path.dirname(args["ckpt_dir"]),
                                 f"{job}_{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--resume-child",
                 json.dumps(args)], env=dict(env), stdout=log,
                stderr=subprocess.STDOUT, text=True, cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, path in zip(procs, logs):
        with open(path) as f:
            text = f.read()
        os.remove(path)
        lines = [ln for ln in text.splitlines() if ln.startswith("RESUME ")]
        result = json.loads(lines[-1][len("RESUME "):]) if lines else None
        if result is not None:
            for key in ("losses", "grad_norms"):
                result[key] = {int(k): v for k, v in result[key].items()}
        out.append((p.returncode, text, result))
    return out


def resume_phase(config, device, ckpt_root, global_batch, seq, steps,
                 storage_every, kill_at):
    """The kill drill (see the module docstring, phase 6). Returns the
    launches of the children's runs and the reference phase 8 holds its
    run against: the unkilled losses, their spread and the longest gap
    between two step reports of any run that was not killed."""
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")

    def args(name, kill=None):
        return dict(device=str(device), config=cfg, steps=steps,
                    global_batch=global_batch, seq=seq,
                    storage_every=storage_every, kill_at=kill,
                    ckpt_dir=os.path.join(ckpt_root, name))

    def run(name, job, kill=None):
        rc, out, res = _run_children(args(name, kill), job)[0]
        if kill is None and (rc != 0 or res is None):
            raise AssertionError(f"resume: run {name} failed ({rc}):\n"
                                 f"{out[-6000:]}")
        return rc, out, res

    def drop(name, job):
        unlink_shared_memory(shm_name(job, 0, 0))
        shutil.rmtree(os.path.join(ckpt_root, name), ignore_errors=True)

    tag = os.getpid()

    def unkilled(name):
        _, _, res = run(name, f"resume_{name}_{tag}")
        drop(name, f"resume_{name}_{tag}")
        return res

    # the first unkilled run alone gives the step times; the second runs
    # beside the drill's first run on the same card (its losses and step
    # gaps are read), which saves one run's time
    results = {"unkilled_a": unkilled("unkilled_a")}
    job = f"resume_drill_{tag}"
    try:
        with ThreadPoolExecutor(1) as pool:
            second = pool.submit(unkilled, "unkilled_b")
            rc, out, killed = run("drill", job, kill=kill_at)
            results["unkilled_b"] = second.result()
        a, b = (results[n]["losses"] for n in ("unkilled_a", "unkilled_b"))
        if sorted(a) != list(range(1, steps + 1)) or sorted(b) != sorted(a):
            raise AssertionError(f"resume: unkilled runs took steps "
                                 f"{sorted(a)} and {sorted(b)}")
        if rc != -signal.SIGKILL or killed is not None:
            raise AssertionError(
                f"resume: the drill's first run ended {rc}, not by SIGKILL "
                f"after step {kill_at}:\n{out[-6000:]}")
        _, _, resumed = run("drill", job)
    finally:
        drop("drill", job)
    counts = [results[n]["launches"] for n in ("unkilled_a", "unkilled_b")]
    spread = max(abs(a[s] - b[s]) / abs(a[s]) for s in a)
    counts.append(resumed["launches"])
    got = resumed["losses"]
    tail = list(range(kill_at + 1, steps + 1))
    worst = max(abs(got.get(s, float("nan")) - a[s]) / abs(a[s])
                for s in tail)
    ok = (resumed["start_step"] == kill_at
          and resumed["restored_from"] == "shm"
          and sorted(got) == tail and worst <= spread)
    # every run's longest gap: unkilled_b's ran beside the drill's first
    # run, so it is if anything longer than one run alone would take
    run_gaps = {n: max(_step_gaps(r))
                for n, r in (*results.items(), ("resumed", resumed))}
    max_gap = max(run_gaps.values())
    step_s = _median_step_s([results["unkilled_a"]["step_s"]],
                            storage_every)
    emit(dict(
        phase="resume", config=dict(dim=config.dim, n_layers=config.n_layers,
                                    dtype=cfg["dtype"]),
        global_batch=global_batch, seq_len=seq, steps=steps,
        storage_every=storage_every, kill_at=kill_at,
        unkilled_losses=[a[s] for s in sorted(a)],
        unkilled_bitwise_equal=a == b, unkilled_max_rel_spread=spread,
        resumed_start_step=resumed["start_step"],
        resumed_from=resumed["restored_from"], restore=resumed["restore"],
        resumed_losses=[got.get(s) for s in tail],
        resumed_max_rel_diff=worst,
        run_seconds={k: v["seconds"] for k, v in results.items()},
        resumed_run_seconds=resumed["seconds"],
        max_step_gap_s=max_gap, run_max_step_gap_s=run_gaps,
        median_step_s=step_s, launches_per_run=counts))
    if not ok:
        raise AssertionError(
            f"resume: resumed at {resumed['start_step']} from "
            f"{resumed['restored_from']}, losses {got} vs unkilled {a} "
            f"(spread {spread})")
    return counts, dict(losses=a, spread=spread, max_gap_s=max_gap,
                        step_s=step_s)


def timer_step_ab(config, device, root, steps=10):
    """``--timer-ab``: phase 6's unkilled child without and with the device
    timer (its hook preloaded, the engine installed by ``worker.init``), in
    turns: off, on, on, off. One row with each run's median step."""
    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory
    from dlrover_tpu_torch.common.rpc import find_free_port
    from dlrover_tpu_torch.tpu_timer import build as timer_build

    lib = str(timer_build.build()["lib"])
    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    runs = []
    for i, on in enumerate((False, True, True, False)):
        job = f"timer_ab_{i}_{os.getpid()}"
        args = dict(device=str(device), config=cfg, steps=steps,
                    global_batch=8, seq=2048, storage_every=5, kill_at=None,
                    ckpt_dir=os.path.join(root, job))
        extra = dict(LD_PRELOAD=lib, TPU_TIMER_ENABLE="1", TPU_TIMER_LIB=lib,
                     TPU_TIMER_PORT=str(find_free_port("127.0.0.1"))
                     ) if on else {}
        saved = {k: os.environ.get(k) for k in extra}
        os.environ.update(extra)
        try:
            rc, out, res = _run_children(args, job)[0]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        unlink_shared_memory(shm_name(job, 0, 0))
        shutil.rmtree(args["ckpt_dir"], ignore_errors=True)
        if rc != 0 or res is None:
            raise AssertionError(f"timer_ab: run {i} failed ({rc}):\n"
                                 f"{out[-6000:]}")
        runs.append(dict(timer=on, median_step_s=_median_step_s(
            [res["step_s"]], args["storage_every"]), step_s=res["step_s"],
            seconds=res["seconds"]))
    emit({"phase": "timer_ab", "runs": runs, "card": _card()})
    return runs


def hang_downtime_for(max_gap_s: float) -> float:
    """The hang rule's downtime for phase 8: half again the longest gap
    between two step reports phase 6 saw, plus 10 s, so no healthy gap
    (a storage save, a restore and the first step) reads as a hang."""
    return float(np.ceil(1.5 * max_gap_s + 10.0))


# --multi: the ranks against one card. Step 1 starts from the same params,
# so only the order of the f32 sums differs (the trainer tests' limits);
# later steps also carry bf16 params rounded from updates that differ in
# their last bits, so they are held looser. A fault in the reduction (a
# grad not averaged over the ranks, a rank on the wrong rows) moves the
# step-1 grad norm by far more than its limit.
MULTI_FIRST_LOSS_TOL, MULTI_FIRST_NORM_TOL = 1e-5, 1e-4
MULTI_LATER_LOSS_TOL, MULTI_LATER_NORM_TOL = 1e-3, 1e-2


def multi_phase(config, device, ckpt_root, ranks, global_batch, seq, steps,
                storage_every, kill_at):
    """The twin across ``ranks`` cards of one host (``--multi``): the
    params as DTensors sharded over fsdp, NCCL collectives in the step,
    each rank saving its own shards. Its losses against one card's, the
    same drill as phase 6 across the ranks, then the node drill under the
    port's agents and master (:func:`node_drill`). Returns the ranks'
    launches and the node drill's."""
    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    tag = os.getpid()

    def run(name, n, kill=None):
        job = f"multi_{name}_{tag}"
        args = dict(device=str(device), config=cfg, steps=steps,
                    global_batch=global_batch, seq=seq,
                    storage_every=storage_every, kill_at=kill,
                    ckpt_dir=os.path.join(ckpt_root, job))
        out = _run_children(args, job, ranks=n)
        bad = [(r, rc) for r, (rc, _, res) in enumerate(out)
               if (rc != -signal.SIGKILL if kill else rc != 0 or res is None)]
        if bad:
            raise AssertionError(f"multi: run {name} ranks {bad} failed:\n"
                                 + out[bad[0][0]][1][-6000:])
        return job, [res for _, _, res in out]

    def drop(job, n):
        for r in range(n):
            unlink_shared_memory(shm_name(job, 0, r))
        shutil.rmtree(os.path.join(ckpt_root, job), ignore_errors=True)

    jobs, runs = [], {}
    try:
        for name, n in (("one", 1), ("a", ranks), ("b", ranks)):
            job, runs[name] = run(name, n)
            drop(job, n)
        job, _ = run("drill", ranks, kill=kill_at)
        jobs.append(job)
        _, runs["resumed"] = run("drill", ranks)
    finally:
        for job in jobs:
            drop(job, ranks)
    one = runs["one"][0]["losses"]
    a, b = runs["a"][0]["losses"], runs["b"][0]["losses"]
    if any(res["losses"] != v[0]["losses"] for v in runs.values()
           for res in v):
        raise AssertionError("multi: the ranks of one run disagree on loss")
    # step 1 starts from the same params: the ranks only sum in another
    # order (the trainer tests' f32 limits); later steps also carry
    # bf16 params rounded from f32 updates that differ in their last bits
    norm_one = runs["one"][0]["grad_norms"]
    norm_a = runs["a"][0]["grad_norms"]

    def rel(x, y):
        return abs(x - y) / abs(y)

    first = dict(loss=rel(a[1], one[1]), grad_norm=rel(norm_a[1], norm_one[1]))
    later = dict(loss=max(rel(a[s], one[s]) for s in one if s > 1),
                 grad_norm=max(rel(norm_a[s], norm_one[s])
                               for s in one if s > 1))
    spread = max(abs(a[s] - b[s]) / abs(a[s]) for s in a)
    resumed = runs["resumed"]
    tail = list(range(kill_at + 1, steps + 1))
    got = resumed[0]["losses"]
    worst = max(abs(got.get(s, float("nan")) - a[s]) / abs(a[s])
                for s in tail)
    ok = (first["loss"] <= MULTI_FIRST_LOSS_TOL
          and first["grad_norm"] <= MULTI_FIRST_NORM_TOL
          and later["loss"] <= MULTI_LATER_LOSS_TOL
          and later["grad_norm"] <= MULTI_LATER_NORM_TOL
          and worst <= spread
          and all(r["start_step"] == kill_at and r["restored_from"] == "shm"
                  for r in resumed))
    counts = {k: sum(res["launches"][k] for res in runs["a"])
              for k in runs["a"][0]["launches"]}
    emit(dict(
        phase="multi", ranks=ranks, config=dict(
            dim=config.dim, n_layers=config.n_layers, dtype=cfg["dtype"]),
        global_batch=global_batch, seq_len=seq, steps=steps,
        kill_at=kill_at, one_card_losses=[one[s] for s in sorted(one)],
        losses=[a[s] for s in sorted(a)],
        one_card_grad_norms=[norm_one[s] for s in sorted(norm_one)],
        grad_norms=[norm_a[s] for s in sorted(norm_a)],
        rel_vs_one_card_step_1=first, rel_vs_one_card_later=later,
        unkilled_bitwise_equal=a == b, unkilled_max_rel_spread=spread,
        resumed_start_steps=[r["start_step"] for r in resumed],
        resumed_from=[r["restored_from"] for r in resumed],
        restore_s=[r["restore"].get("seconds") for r in resumed],
        resumed_losses=[got.get(s) for s in tail],
        resumed_max_rel_diff=worst,
        run_seconds={k: v[0]["seconds"] for k, v in runs.items()},
        launches_per_run_all_ranks=counts))
    if not ok:
        raise AssertionError(
            f"multi: vs one card, step 1 {first}, later {later}, "
            f"resumed {[(r['start_step'], r['restored_from'])
                        for r in resumed]} losses {got} vs {a} "
            f"(spread {spread})")
    drill = node_drill(config, device, ckpt_root, ranks, global_batch, seq,
                       steps, storage_every, rejoin_at=8, reference=a)
    return counts, drill


def node_drill(config, device, ckpt_root, ranks, global_batch, seq, steps,
               storage_every, rejoin_at, reference, replica=True,
               pace_s=4.0, seed_dir=None, loss_tol=None, timer=True):
    """The kill-shrink-rejoin drill across cards (``--multi``): a port
    master in this process and two port agents of ``ranks // 2`` workers
    each (one card a worker, NCCL, fsdp over the world), their steps paced
    ``pace_s`` apart. Agent 1's process group is SIGKILLed once storage
    holds step ``storage_every`` and, with ``replica`` (both agents run
    ``--ckpt-replica 2``), once node 0's replica store holds every frame
    of both nodes at one step past storage's newest. The master's
    connection-drop grace
    declares node 1 dead and the survivor re-forms the world at half the
    ranks with twice the accumulation steps: its live reshard aborts on
    its coverage proof (the dead node's shards are in no survivor's
    frame), its shm cannot cover them either, and it restores from the
    peer frames in node 0's store at that step (without ``replica``: from
    storage). Agent 1 comes back once the small world has done step
    ``rejoin_at``, and every rank of the world at ``ranks`` restores by
    live reshard from node 0's frames, node 1's ranks over the fabric; no
    rank reads storage after the kill. Each step's loss (its last
    incarnation's) is held against ``reference`` within ``loss_tol``
    (``MULTI_LATER_LOSS_TOL``). ``seed_dir``: a checkpoint directory the
    run starts from (its storage step 0). ``timer``: the agents run the
    device timer, and before the kill every rank must show one hooked
    collective count and no hang (the CPU rehearsal, on gloo, has no
    hooked collective)."""
    from dlrover_tpu_torch.ckpt.ckpt_saver import latest_step
    from dlrover_tpu_torch.ckpt.replica import addr_key
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory
    from dlrover_tpu_torch.common.rpc import RPCClient, find_free_port
    from dlrover_tpu_torch.master.master import LocalJobMaster

    loss_tol = MULTI_LATER_LOSS_TOL if loss_tol is None else loss_tol
    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    job = f"nd{os.getpid()}{'r' if replica else 's'}"
    ckpt_dir = os.path.join(ckpt_root, job)
    if seed_dir is not None:
        shutil.copytree(seed_dir, ckpt_dir)
    args = dict(device=str(device), config=cfg, steps=steps,
                global_batch=global_batch, seq=seq,
                storage_every=storage_every, ckpt_dir=ckpt_dir,
                pace_s=pace_s)
    per_node = ranks // 2
    ctx = get_context()
    ctx.heartbeat_interval_s = 1.0
    master = LocalJobMaster(job_name=job, node_num=2, min_nodes=1,
                            max_nodes=2)
    master.prepare()
    logs = []

    # each agent's device-timer daemon and its workers' metric ports: the
    # hook's entry markers of the NCCL all-reduces ride the beats
    timer_ports = {r: (find_free_port("127.0.0.1"),
                       find_free_port("127.0.0.1")) for r in (0, 1)}

    def start_agent(rank):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DLROVER_")}
        env.update({"PYTHONPATH": REPO,
                    "DLROVER_TPU_HEARTBEAT_INTERVAL_S": "1",
                    "TPU_TIMER_DAEMON_PORT": str(timer_ports[rank][0]),
                    "TPU_TIMER_PORT": str(timer_ports[rank][1])})
        if device.type == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(rank * per_node + i) for i in range(per_node))
        logs.append(os.path.join(ckpt_root, f"{job}_agent{rank}_{len(logs)}"))
        with open(logs[-1], "w") as log:
            return subprocess.Popen(
                [sys.executable, "-c", ELASTIC_AGENT,
                 f"--master-addr={master.addr}", "--nnodes=1:2",
                 f"--node-rank={rank}", f"--nproc-per-node={per_node}",
                 f"--job_name={job}", "--monitor-interval=0.1",
                 *(["--tpu-timer"] if timer else []),
                 *(["--ckpt-replica=2"] if replica else []),
                 "--max-restarts=3", f"--ckpt_dir={ckpt_dir}",
                 os.path.abspath(__file__), "--node-child",
                 json.dumps(args)],
                env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
                cwd=REPO, start_new_session=True)

    def step_lines():
        out = []
        for path in logs:
            with open(path) as f:
                out.extend(_lines(f.read(), "STEP"))
        return out

    def logs_tail():
        keep = ("Error", "error", "commit", "persist", "skip", "restor",
                "rendezvous", "restart", "failure", "released", "reshard",
                "replica", "WARNING", "STEP")
        out = []
        for path in logs:
            with open(path) as f:
                out += [f"{os.path.basename(path)}: {ln[:300]}"
                        for ln in f.read().splitlines()
                        if any(k in ln for k in keep)]
        return "\n".join(out[-80:])

    def wait(cond, what, timeout=300):
        deadline = time.monotonic() + timeout
        while not cond():
            gone = [r for r, p in agents.items() if p.poll() is not None]
            if time.monotonic() > deadline or gone:
                what = what() if callable(what) else what
                raise AssertionError(
                    f"node drill: no {what} (agents exited: {gone}):\n"
                    + logs_tail())
            time.sleep(0.2)

    held = {}

    def stored_past_storage():
        """Node 0's store holds every frame of both nodes at one step past
        storage's newest (it keeps each owner's last two steps, so a save
        node 1 dies in leaves that step whole)."""
        if "client" not in held:
            addr = master.kv_store.get(addr_key(job, 0))
            if not addr:
                return False
            held["client"] = RPCClient(bytes(addr).decode(), timeout_s=10,
                                       retries=2)
        try:
            entries = held["client"].call("replica_list",
                                          comm.BaseRequest()).entries
        except (ConnectionError, OSError):
            held.pop("client")  # asked again; an agent gone ends the wait
            return False
        owners = {}
        for o, lr, st in entries:
            owners.setdefault((o, lr), set()).add(st)
        held["seen"] = {f"{o}_{lr}": sorted(st) for (o, lr), st
                        in sorted(owners.items())}
        common = set.intersection(*[owners.get((n, lr), set())
                                    for n in (0, 1)
                                    for lr in range(per_node)])
        past = [st for st in common if st > latest_step(ckpt_dir)]
        if past:
            held["step"] = max(past)
            return True
        return False

    agents = {0: start_agent(0), 1: start_agent(1)}
    journal = []
    try:
        # the small world restores from storage without replicas: it must
        # hold a step
        wait(lambda: latest_step(ckpt_dir) >= storage_every,
             f"storage commit of step {storage_every}")
        # steady state: every rank entered the same number of collectives
        # (the steps are paced, so the ranks idle together between them)
        # and the skew monitor sees no hang
        steady = {"coll": None}

        def equal_collectives():
            steady["coll"] = master.skew_monitor.last_collectives()
            seqs = {c.get("seq", 0) for c in steady["coll"].values()}
            return len(steady["coll"]) == ranks and len(seqs) == 1 \
                and seqs.pop() > 0
        if timer:
            wait(equal_collectives, "equal collective counters", 60)
            steady["hang"] = master.skew_monitor.current_verdicts()["hang"]
            if steady["hang"] is not None:
                raise AssertionError(f"node drill: a hang verdict in "
                                     f"steady state: {steady}")
        if replica:
            wait(stored_past_storage, lambda: (
                f"frames of both nodes in node 0's store past storage's "
                f"step (the store held {held.get('seen')}, storage "
                f"{latest_step(ckpt_dir)})"), 300)
        killed_after = max(r["step"] for r in step_lines())
        os.killpg(agents[1].pid, signal.SIGKILL)
        t_kill = time.time()
        storage_at_kill = latest_step(ckpt_dir)
        agents.pop(1).wait()
        wait(lambda: master.job_manager.nodes[1].is_released,
             "the master declaring node 1 dead", 120)
        detect_s = time.time() - t_kill
        wait(lambda: any(r["world"] == per_node and r["step"] >= rejoin_at
                         for r in step_lines()), f"step {rejoin_at} at "
             f"world {per_node}")
        t_rejoin = time.time()
        agents[1] = start_agent(1)
        codes = {r: p.wait(timeout=900) for r, p in agents.items()}
        journal = master.event_journal.events()
    finally:
        for p in agents.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        master.stop()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                unlink_shared_memory(name)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    text = ""
    for path in logs:
        with open(path) as f:
            text += f.read()
        os.remove(path)
    starts = _lines(text, "START")
    steps_seen = sorted(_lines(text, "STEP"), key=lambda r: r["t"])
    losses, launches = {}, {}
    for r in steps_seen:
        losses[r["step"]] = r["loss"]
        launches[(r["node"], r["restart"])] = r["launches"]
    segments = []
    for r in sorted((r for r in starts if r["rank"] == 0),
                    key=lambda r: r["t"]):
        segments.append(dict(world=r["world"], grad_accum=r["grad_accum"],
                             start_step=r["start_step"],
                             medium=r["restore"].get("medium"),
                             restore_s=r["restore"].get("seconds")))
    worst = max(abs(losses.get(s, float("nan")) - reference[s])
                / abs(reference[s]) for s in reference)
    shrink = [g for g in segments if g["world"] == per_node]
    back = [g for g in segments[segments.index(shrink[0]):]
            if g["world"] == ranks and g["start_step"] < steps] if shrink \
        else []
    worlds = [g["world"] for g in segments]
    # the first incarnation of the small world, and of the world after
    # the rejoin: one START line a rank
    after_kill = sorted((r for r in starts if r["t"] > t_kill),
                        key=lambda r: r["t"])
    shrink_ranks = [r for r in after_kill if r["world"] == per_node
                    ][:per_node]
    rejoined = [r for r in after_kill if r["t"] > t_rejoin
                and r["world"] == ranks][:ranks]
    kinds = [e["kind"] for e in journal]
    aborts = [e["data"].get("reason") for e in journal
              if e["kind"] == "reshard_aborted"]
    reshard_rows = [dict(node=r["node"], rank=r["rank"],
                         seconds=r["restore"].get("seconds"),
                         **{k: r["restore"].get("reshard", {}).get(k)
                            for k in ("bytes_local", "bytes_remote",
                                      "duration_s")})
                    for r in rejoined]
    emit(dict(
        phase="node_drill", ranks=ranks, per_node=per_node, steps=steps,
        replica=replica, killed_after_step=killed_after,
        storage_at_kill=storage_at_kill, rejoin_at=rejoin_at,
        steady_collectives=steady["coll"],
        agent_exit=codes,
        detect_s=detect_s, segments=segments,
        restores_after_kill=[dict(node=r["node"], rank=r["rank"],
                                  world=r["world"],
                                  start_step=r["start_step"],
                                  medium=r["restore"].get("medium"),
                                  seconds=r["restore"].get("seconds"),
                                  warm=r.get("warm"))
                             for r in after_kill],
        reshard_aborts=aborts, reshard_complete=kinds.count(
            "reshard_complete"), rejoin_reshard=reshard_rows,
        pushes=_push_rows(steps_seen),
        losses=[losses.get(s) for s in range(1, steps + 1)],
        max_rel_diff_vs_unkilled=worst, loss_tol=loss_tol,
        launches_rank0=[launches[k] for k in sorted(launches)]))
    problems = []
    if not (codes == {0: 0, 1: 0} and sorted(losses) == list(
            range(1, steps + 1)) and worst <= loss_tol
            and worlds[:1] == [ranks] and bool(shrink) and bool(back)
            and shrink[0]["grad_accum"] == 2 * segments[0]["grad_accum"]
            and back[0]["grad_accum"] == segments[0]["grad_accum"]):
        problems.append("the drill's worlds, exits or losses")
    if not replica:
        if shrink and shrink[0]["medium"] != "storage":
            problems.append("the shrink without replicas did not restore "
                            "from storage")
    else:
        # the shrink: every rank from the peer frames at the step the
        # store held, past storage's; its reshard aborted on coverage
        if (len(shrink_ranks) < per_node or any(
                (r["restore"].get("medium"), r["start_step"])
                != ("replica", held.get("step")) for r in shrink_ranks)
                or not held.get("step", -1) > storage_at_kill
                or "coverage" not in aborts):
            problems.append(f"the shrink's restores (store step "
                            f"{held.get('step')}, storage {storage_at_kill},"
                            f" aborts {aborts})")
        # the rejoin: every rank by live reshard, node 1's over the fabric
        if (len(rejoined) != ranks or any(
                r["restore"].get("medium") != "reshard" for r in rejoined)
                or any(not (r["restore"].get("reshard") or {}).get(
                    "bytes_remote") for r in rejoined if r["node"] == 1)
                or kinds.count("reshard_complete") < ranks):
            problems.append(f"the rejoin's restores {reshard_rows}")
        if any(r["restore"].get("medium") == "storage" for r in after_kill):
            problems.append("a rank read storage after the kill")
    if problems:
        raise AssertionError(f"node drill: {'; '.join(problems)}: segments "
                             f"{segments}, losses {losses} vs {reference} "
                             f"(worst {worst}), exits {codes}:\n"
                             f"{text[-6000:]}")
    return list(launches.values())


NODE_DRILL_STEPS, NODE_DRILL_REJOIN = 12, 10


def node_drill_alone(config, device, ranks):
    """``--node-drill N``: one unkilled run across N cards as the
    reference, then the node drill, both NODE_DRILL_STEPS long: the kill
    waits for node 0's replica store to hold both nodes' frames past
    storage's step 5, a few steps after it on the cards, and the small
    world must still train past NODE_DRILL_REJOIN before the rejoin."""
    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    root = os.path.join(REPO, ".chip_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    job = f"node_ref_{os.getpid()}"
    try:
        args = dict(device=str(device), config=cfg, steps=NODE_DRILL_STEPS,
                    global_batch=8, seq=2048, storage_every=5, kill_at=None,
                    ckpt_dir=os.path.join(root, "ref"))
        out = _run_children(args, job, ranks=ranks)
        for r in range(ranks):
            unlink_shared_memory(shm_name(job, 0, r))
        bad = [(r, rc) for r, (rc, _, res) in enumerate(out)
               if rc != 0 or res is None]
        if bad:
            raise AssertionError(f"node drill: reference ranks {bad} "
                                 f"failed:\n{out[bad[0][0]][1][-6000:]}")
        ref = out[0][2]["losses"]
        emit({"phase": "node_drill_reference", "ranks": ranks,
              "losses": [ref[s] for s in sorted(ref)],
              "seconds": out[0][2]["seconds"]})
        shutil.rmtree(args["ckpt_dir"], ignore_errors=True)
        return node_drill(config, device, root, ranks, global_batch=8,
                          seq=2048, steps=NODE_DRILL_STEPS, storage_every=5,
                          rejoin_at=NODE_DRILL_REJOIN, reference=ref)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def elastic_alone(config, device):
    """``--elastic``: one unkilled run of phase 6's child as the
    reference, then phase 8."""
    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    root = os.path.join(REPO, ".chip_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    job = f"elastic_ref_{os.getpid()}"
    try:
        args = dict(device=str(device), config=cfg, steps=10,
                    global_batch=8, seq=2048, storage_every=5, kill_at=None,
                    ckpt_dir=os.path.join(root, "ref"))
        rc, out, ref = _run_children(args, job)[0]
        if rc != 0 or ref is None:
            raise AssertionError(f"elastic: reference run failed ({rc}):\n"
                                 f"{out[-6000:]}")
        from dlrover_tpu_torch.ckpt.shm_handler import shm_name
        from dlrover_tpu_torch.common.multi_process import (
            unlink_shared_memory,
        )

        unlink_shared_memory(shm_name(job, 0, 0))
        max_gap = max(_step_gaps(ref))
        emit({"phase": "elastic_reference", "losses": [
            ref["losses"][s] for s in sorted(ref["losses"])],
            "max_step_gap_s": max_gap, "step_gaps_s": _step_gaps(ref),
            "seconds": ref["seconds"]})
        return elastic_phase(
            config, device, root, global_batch=8, seq=2048, steps=10,
            storage_every=5,
            reference=dict(losses=ref["losses"], spread=0.0,
                           step_s=_median_step_s([ref["step_s"]], 5)),
            hang_downtime_s=hang_downtime_for(max_gap))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# --parallel: sequence and pipeline parallelism across the host's cards
# ---------------------------------------------------------------------------

# The Llama layouts at LlamaConfig() widths (dim 4096, 32 heads, 8 KV
# heads, head_dim 128, remat "dots"), the MoE layouts at MoEConfig() widths
# (Mixtral 8x7B: the same attention, 8 experts, top 2, ffn 14336), 3
# ElasticTrainer steps from one seed each, one micro step a step unless
# "micro_batch" says otherwise
PARALLEL_LAYOUTS = {
    # 32768 tokens, 8192 a rank; rank r runs 1 + r chunks of K1-K3
    "ring": dict(axes=dict(sp=4), layers=2, sp_attention="ring",
                 global_batch=1, seq=32768),
    # the same shape; 8 q and 2 KV heads a rank after the scatter
    "ulysses": dict(axes=dict(sp=4), layers=2, sp_attention="ulysses",
                    global_batch=1, seq=32768),
    # 2 layers a stage, 16 microbatches of one row (M = 16, T = 19 ticks);
    # each stage holds, gathers and accumulates its own 2 layers
    "gpipe": dict(axes=dict(pp=4), layers=8, sp_attention=None,
                  global_batch=16, seq=2048),
    # the moe phase's train step (8 x 2048 as 2 micro batches of 4) on 4
    # cards, 2 experts a card: every card routes all rows (ep takes no
    # rows) and runs its own experts
    "moe_ep": dict(model="moe", axes=dict(ep=4), layers=2,
                   sp_attention=None, global_batch=8, micro_batch=4,
                   seq=2048),
    # the reference test's layout (tests/test_moe.py, ep 2 x sp 2, ring)
    # at full width: 1 x 16384 tokens, 8192 a card; the routing group is
    # the whole sequence, so capacity is claimed across both sp ranks
    "moe_sp": dict(model="moe", axes=dict(ep=2, sp=2), layers=2,
                   sp_attention="ring", global_batch=1, seq=16384),
    # the train phase's step (8 x 2048 as 2 micro batches of 4) at fsdp 4:
    # one row a card a micro step; each card holds, accumulates and
    # updates a quarter of every matrix and gathers one layer's blocks
    # at a time, in its forward and again in its recompute
    "fsdp": dict(axes=dict(fsdp=4), layers=8, sp_attention=None,
                 global_batch=8, micro_batch=4, seq=2048),
    # the same step at tp 4: every card runs all rows on its 8 q and 2 KV
    # heads (K1-K3 on those), its quarter of the MLP columns and of the
    # vocab
    "tp": dict(axes=dict(tp=4), layers=8, sp_attention=None,
               global_batch=8, micro_batch=4, seq=2048),
    # fsdp 2 x tp 2: two rows a card a micro step on 16 q and 4 KV heads
    "fsdp_tp": dict(axes=dict(fsdp=2, tp=2), layers=8, sp_attention=None,
                    global_batch=8, micro_batch=4, seq=2048),
    # the moe phase's train step at ep 2 x fsdp 2: two rows a card a micro
    # step, each card's 4 experts with their embed dim gathered a layer at
    # a time
    "moe_fsdp": dict(model="moe", axes=dict(ep=2, fsdp=2), layers=2,
                     sp_attention=None, global_batch=8, micro_batch=4,
                     seq=2048),
    # the same step at ep 2 x tp 2: all rows on every card, 16 q and 4 KV
    # heads, 4 experts' halves of the FFN columns
    "moe_tp": dict(model="moe", axes=dict(ep=2, tp=2), layers=2,
                   sp_attention=None, global_batch=8, micro_batch=4,
                   seq=2048),
}
PARALLEL_STEPS = 3
# one control a layout, each breaking its communication (and not the
# launches): the ring's hops deliver nothing (each rank attends its own
# chunk in place of every earlier one); Ulysses swaps the first two
# sequence chunks it gathers; each pipeline hop delivers the tick
# before's output; the MoE FFN's from_region keeps the rank's partial
# combine (its experts' share of every token's output); each sp rank
# routes its chunk as its own groups; the fsdp gather returns the rank's
# own block in every slot; the tp region's g keeps the rank's partial
# (its heads', columns' or vocab rows' share)
PARALLEL_CONTROLS = {"ring_drop": "ring", "ulysses_swap": "ulysses",
                     "gpipe_stale": "gpipe", "moe_ep_partial": "moe_ep",
                     "moe_sp_local_groups": "moe_sp",
                     "fsdp_own_shard": "fsdp", "tp_no_reduce": "tp"}
# the checks besides the readings a control may fail: with partial
# combines the ranks hold different outputs, and so different losses
PARALLEL_CONTROL_ALSO_FAILS = {"moe_ep_partial": ("ranks_agree",)}
# the axes along which the layouts' trainers keep each rank's block
PARALLEL_LOCAL_AXES = ("pp", "ep", "fsdp", "tp")
# The layouts against one card's run of the same steps (same params, same
# batches; plain attention over the whole sequence there), relative
# differences: each step's loss, each step's grad norm, and every leaf's
# grad norm at step 1. Each sits between the sound layouts' largest
# reading and every control's (PERF.md §6): loss 9.8e-6 against
# 8.4e-4 at the least; grad norm 3.3e-4 against 0.088; leaf norm 2.1e-4
# against 0.0108.
PARALLEL_LOSS_REL_TOL = 1e-4
PARALLEL_NORM_REL_TOL = 3e-3
PARALLEL_LEAF_NORM_REL_TOL = 2e-3
# The MoE layouts' limits, and the share of step 1's routing decisions
# that differ from one card's (route flips, as in the moe phase): a
# token whose choices sit near a tie takes another expert under another
# attention path's bf16 rounding, and its FFN output changes outright
# (5.6% of the moe phase's decisions between two attention paths), so
# the MoE layouts get limits of their own. On 4 H100s (700 W) moe_ep
# equalled one card (0 flips, loss and norms bitwise, leaf norms 9.0e-8);
# moe_sp flipped 0.49% of step 1's decisions, and the flips compound over
# the steps: loss 8.9e-4 and grad norm 0.0267 at step 3, leaf norms
# 5.1e-3.
# moe_ep_partial read loss 1.43e-3, grad norm 0.122, leaf norms 0.334,
# flips 0.382; moe_sp_local_groups loss 8.0e-4 and grad norm 0.0158 (no
# limit can part those from the sound run's), leaf norms 0.099 (the
# router) and flips 0.156. Each limit sits between the sound readings
# and a control's (PERF.md §6), and each control fails at least two.
MOE_PARALLEL_LOSS_REL_TOL = 1.2e-3
MOE_PARALLEL_NORM_REL_TOL = 6e-2
MOE_PARALLEL_LEAF_NORM_REL_TOL = 2e-2
MOE_PARALLEL_FLIP_SHARE_MAX = 0.05


def _parallel_launch_want(spec, name, rank, world, steps):
    """K1-K3 launches of one rank's steps (remat "dots": K1 twice a layer
    a micro step, forward and recompute). On the ring, the rank at sp
    coordinate c (the innermost axis but tp) runs 1 + c chunks; a
    pipeline stage runs its layers at every one of the M + pp - 1 ticks,
    forward and backward; an ep rank runs every layer's attention on
    every row."""
    L = spec["layers"]
    accum = spec["global_batch"] // spec.get("micro_batch",
                                             spec["global_batch"])
    per = L * accum
    if world > 1 and spec["sp_attention"] == "ring":
        per *= 1 + rank % spec["axes"]["sp"]
    elif world > 1 and name == "gpipe":
        pp = spec["axes"]["pp"]
        per = L // pp * (spec["global_batch"] + pp - 1)
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want.update(flash_fwd=2 * per * steps, flash_bwd_dq=per * steps,
                flash_bwd_dkv=per * steps)
    return want


@contextlib.contextmanager
def _parallel_control(name):
    """Install control ``name`` (PARALLEL_CONTROLS) while inside."""
    saved = []

    def patch(module, attr, value):
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    if name == "ring_drop":
        patch(ring_attention, "shift", lambda tensors, group, **kw:
              tuple(tensors))
    elif name == "ulysses_swap":
        real = ulysses.all_to_all

        def swapped(x, group, scatter_dim, gather_dim):
            out = real(x, group, scatter_dim, gather_dim)
            if gather_dim != 2:
                return out
            n = out.shape[2] // torch.distributed.get_world_size(group)
            order = torch.arange(out.shape[2], device=out.device)
            order = torch.cat([order[n:2 * n], order[:n], order[2 * n:]])
            return out.index_select(2, order)
        patch(ulysses, "all_to_all", swapped)
    elif name == "gpipe_stale":
        real = pipeline.shift
        last = []

        def stale(tensors, group, **kw):
            got = real(tensors, group, **kw)
            out = last.pop() if last else tuple(torch.zeros_like(t)
                                                for t in got)
            last.append(got)
            return out
        patch(pipeline, "shift", stale)
    elif name == "moe_ep_partial":
        patch(moe, "from_region", lambda x, group: x.clone())
    elif name == "moe_sp_local_groups":
        route = moe._route

        def local_groups(x, router, c, capacity, g, group, r):
            # the chunk of each row its own group, at the same capacity
            return route(x, router, c, capacity)
        patch(moe, "_route_sp", local_groups)
    elif name == "fsdp_own_shard":
        def own_block(x, group, dim):
            n = torch.distributed.get_world_size(group)
            return torch.cat([x.detach()] * n, dim)
        patch(collectives, "_all_gather", own_block)
    elif name == "tp_no_reduce":
        patch(llama, "from_region", lambda x, group: x.clone())
    elif name is not None:
        raise ValueError(f"unknown control {name!r}; expected one of "
                         f"{sorted(PARALLEL_CONTROLS)}")
    try:
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)


def _leaf_sq_norms(grads, params, mesh):
    """Squared global norm of every leaf of ``grads`` (each rank's local
    shard after the trainer's reduction), in tree_leaves order: each
    region counted once (on the rank at coordinate 0 of its replica
    axes), summed over the world."""
    sq = torch.stack([g.float().square().sum() for g in tree_leaves(grads)])
    if mesh is None:
        return sq
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    owner = torch.tensor(
        [all(coords[a] == 0 for a in replica_axes(dtensor_spec(p), sizes))
         for p in tree_leaves(params)], dtype=sq.dtype, device=sq.device)
    sq = sq * owner
    torch.distributed.all_reduce(sq)
    return sq


def _count_plain_launches():
    """On the CPU (a rehearsal) count the plain versions that stand in for
    K1-K3 as their launches, so the launch formulas can be checked there."""
    def counted(fn, names):
        def call(*a, **kw):
            for n in names:
                fa.LAUNCHES[n] += 1
            return fn(*a, **kw)
        return call
    fa.flash_attention_plain = counted(fa.flash_attention_plain,
                                       ["flash_fwd"])
    fa.flash_attention_bwd_plain = counted(
        fa.flash_attention_bwd_plain, ["flash_bwd_dq", "flash_bwd_dkv"])


def parallel_child(args) -> int:
    """One rank of ``--parallel`` (or, at world 1, the one-card
    reference): each layout's steps, then one ``PARALLEL {json}`` line.
    A MoE layout's step-1 routing decisions go to ``args["route_dir"]``
    (``<layout>_<rank>.pt``). ``args["shrink"]`` (a CPU rehearsal)
    overrides the configs' (``config``, ``moe_config``) and the layouts'
    sizes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = worker.init(device=args.get("device", "cuda"))
    device = ctx.device
    shrink = args.get("shrink") or {}
    if device.type == "cpu":
        _count_plain_launches()
    out = {}
    for name in args["layouts"]:
        spec = dict(PARALLEL_LAYOUTS[name], **shrink.get(name, {}))
        is_moe = spec.get("model") == "moe"
        family = moe if is_moe else llama
        c = dataclasses.replace(
            moe.MoEConfig() if is_moe else llama.LlamaConfig(),
            n_layers=spec["layers"], sp_attention=spec["sp_attention"],
            **shrink.get("moe_config" if is_moe else "config", {}))
        gb, seq = spec["global_batch"], spec["seq"]
        params = family.init_params(
            c, torch.Generator(device=device).manual_seed(SEED + 2), device)
        mesh = None
        plan = plan_mesh(1)
        if ctx.world_size > 1:
            plan = plan_mesh(ctx.world_size, **spec["axes"])
            mesh = build_mesh(plan, device.type)
            params = shard_tree(mesh, params, family.param_logical_axes(c))
        local_axes = ()
        if mesh is not None:
            local_axes = tuple(a for a in PARALLEL_LOCAL_AXES
                               if spec["axes"].get(a, 1) > 1)
        if "pp" in local_axes:
            def loss_fn(p, t, c=c, mesh=mesh):
                return llama.next_token_loss_pp(p, t, c, mesh)
        else:
            def loss_fn(p, t, c=c, mesh=mesh, family=family):
                return family.next_token_loss(p, t, c, mesh)
        opt = adamw(3e-4)
        first = []

        def update(grads, opt_state, ps, opt=opt, first=first,
                   params=params, mesh=mesh):
            if not first:
                first.append(_leaf_sq_norms(grads, params, mesh).sqrt())
            return opt.update(grads, opt_state, ps)

        trainer = ElasticTrainer(
            loss_fn, opt._replace(update=update), gb,
            spec.get("micro_batch", gb) // plan.dp_total, device=device,
            local_axes=local_axes)
        accum = trainer.configure_for_world(plan)
        state = make_train_state(params, opt)
        batches = np.random.default_rng(SEED).integers(
            0, c.vocab_size, (PARALLEL_STEPS, gb, seq + 1),
            dtype=np.int32).reshape(PARALLEL_STEPS, accum, gb // accum,
                                    seq + 1)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        fa.reset_launch_counts()
        losses, norms, step_s = [], [], []
        with _parallel_control(args.get("control")):
            for i, b in enumerate(batches):
                _sync(device)
                t0 = time.perf_counter()
                with record_routes(c if i == 0 else None) as routes:
                    state, res = trainer.train_step(state, b)
                losses.append(float(res.loss))
                norms.append(float(res.grad_norm))
                step_s.append(time.perf_counter() - t0)
                if routes and args.get("route_dir"):
                    torch.save([(e.to("cpu", torch.uint8), k.cpu())
                                for e, k in routes],
                               os.path.join(args["route_dir"],
                                            f"{name}_{ctx.rank}.pt"))
        out[name] = dict(
            losses=losses, grad_norms=norms, step_s=step_s,
            leaf_norms=dict(zip(_leaf_names(params),
                                first[0].tolist())),
            launches=_launches(),
            peak_memory_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                            if device.type == "cuda" else None))
        del params, state, trainer, first
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print("PARALLEL " + json.dumps(out), flush=True)
    worker.shutdown()
    return 0


def _parallel_runs(layouts, ranks, control=None, device="cuda",
                   shrink=None, route_dir=None, timeout=900):
    """``parallel_child`` in ``ranks`` processes, one card each; their
    PARALLEL results by rank."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update(DLROVER_TPU_WORLD_SIZE=str(ranks),
               DLROVER_TPU_LOCAL_WORLD_SIZE=str(ranks),
               DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}")
    args = json.dumps(dict(layouts=layouts, control=control,
                           device=str(device), shrink=shrink,
                           route_dir=route_dir))
    procs, logs = [], []
    try:
        for r in range(ranks):
            env.update(DLROVER_TPU_RANK=str(r), DLROVER_TPU_LOCAL_RANK=str(r))
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--parallel-child", args], env=dict(env), stdout=logs[-1],
                stderr=subprocess.STDOUT, text=True, cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("PARALLEL ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"parallel: rank {r} of {ranks} failed "
                                 f"({p.returncode}):\n{text[-6000:]}")
        results.append(json.loads(lines[-1][len("PARALLEL "):]))
    return results


def _rel(x, y):
    return abs(x - y) / abs(y)


def _parallel_flips_between(one_path, spread_dir, name, spec, ranks):
    """(decisions that differ, decisions) between one card's step-1
    routing of a MoE layout (``one_path``) and the ranks': the ranks at
    ep and tp coordinate 0 hold the rows (along fsdp) and the sp chunks
    of one card's batch, joined in their mesh order."""
    one = torch.load(one_path)
    plan = plan_mesh(ranks, **spec["axes"])
    coords = {r: plan_coords(plan, r) for r in range(ranks)}
    holders = sorted((c["fsdp"], c["sp"], r) for r, c in coords.items()
                     if c["ep"] == c["tp"] == 0)
    parts = {}
    for f, _, r in holders:
        parts.setdefault(f, []).append(
            torch.load(os.path.join(spread_dir, f"{name}_{r}.pt")))
    if any(len(c) != len(one) for row in parts.values() for c in row):
        raise AssertionError(
            f"parallel {name}: {len(one)} routing calls on one card, "
            f"{[len(c) for row in parts.values() for c in row]} on {ranks}")
    joined = [tuple(torch.cat([torch.cat([c[i][j] for c in row], dim=1)
                               for _, row in sorted(parts.items())], dim=0)
                    for j in range(2)) for i in range(len(one))]
    return route_flips(joined, [tuple(t.reshape(j[0].shape) for t in call)
                                for call, j in zip(one, joined)])


def _one_card_runs(layouts, shrink):
    """``layout -> the layout whose one-card run it shares``: one card's
    steps depend on the model, its depth and the batch, not on the axes
    nor on the sp strategy (one card attends over the whole sequence)."""
    first, out = {}, {}
    for name in layouts:
        spec = dict(PARALLEL_LAYOUTS[name], **shrink.get(name, {}))
        key = json.dumps({k: v for k, v in spec.items()
                          if k not in ("axes", "sp_attention")},
                         sort_keys=True)
        out[name] = first.setdefault(key, name)
    return out


def parallel_phase(ranks, control=None, device="cuda", shrink=None):
    """``--parallel N``: each layout of PARALLEL_LAYOUTS (or, with
    ``control``, only the one it breaks) across ``ranks`` cards, against
    one card's run of the same steps. Held: every rank's K1-K3 launches
    at its layout's formula, all ranks at one loss and grad norm, each
    step's loss and grad norm and every leaf's step-1 grad norm within
    the PARALLEL_* limits (the MOE_PARALLEL_* ones for a MoE layout,
    with the share of step 1's routing decisions that differ from one
    card's). Prints each layout's readings, step time, tokens/s and peak
    memory a card. Returns the names of the checks that failed (a sound
    run raises instead). Rehearse on the CPU with ``device="cpu"`` and a
    ``shrink`` of tiny sizes (``{"config": {...}, "moe_config": {...},
    <layout>: {...}}``; gloo ranks, the plain versions counted as the
    kernels' launches)."""
    layouts = ([PARALLEL_CONTROLS[control]] if control
               else list(PARALLEL_LAYOUTS))
    shrink = shrink or {}
    t0 = time.perf_counter()
    route_dir = tempfile.mkdtemp(prefix="chip_smoke_routes_")
    try:
        one_dir, spread_dir = (os.path.join(route_dir, d)
                               for d in ("one", "spread"))
        os.makedirs(one_dir)
        os.makedirs(spread_dir)
        shared = _one_card_runs(layouts, shrink)
        one = _parallel_runs([n for n in layouts if shared[n] == n], 1,
                             None, device, shrink, one_dir)[0]
        spread = _parallel_runs(layouts, ranks, control, device, shrink,
                                spread_dir)
        flips = {}
        for name in layouts:
            spec = dict(PARALLEL_LAYOUTS[name], **shrink.get(name, {}))
            if spec.get("model") == "moe":
                flips[name] = _parallel_flips_between(
                    os.path.join(one_dir, f"{shared[name]}_0.pt"),
                    spread_dir, name, spec, ranks)
    finally:
        shutil.rmtree(route_dir, ignore_errors=True)
    failed = []
    for name in layouts:
        spec = dict(PARALLEL_LAYOUTS[name], **shrink.get(name, {}))
        is_moe = spec.get("model") == "moe"
        limits = ([MOE_PARALLEL_LOSS_REL_TOL, MOE_PARALLEL_NORM_REL_TOL,
                   MOE_PARALLEL_LEAF_NORM_REL_TOL] if is_moe else
                  [PARALLEL_LOSS_REL_TOL, PARALLEL_NORM_REL_TOL,
                   PARALLEL_LEAF_NORM_REL_TOL])
        ref, runs = one[shared[name]], [res[name] for res in spread]
        got = runs[0]
        checks = {}
        checks["launches"] = (
            ref["launches"] == _parallel_launch_want(spec, name, 0, 1,
                                                     PARALLEL_STEPS)
            and all(res["launches"] == _parallel_launch_want(
                spec, name, r, ranks, PARALLEL_STEPS)
                for r, res in enumerate(runs)))
        checks["ranks_agree"] = all(
            res["losses"] == got["losses"]
            and res["grad_norms"] == got["grad_norms"] for res in runs)
        loss_rel = [_rel(a, b) for a, b in zip(got["losses"], ref["losses"])]
        norm_rel = [_rel(a, b) for a, b in zip(got["grad_norms"],
                                                ref["grad_norms"])]
        leaf_rel = {n: _rel(got["leaf_norms"][n], v)
                    for n, v in ref["leaf_norms"].items()}
        checks["losses"] = max(loss_rel) <= limits[0]
        checks["grad_norms"] = max(norm_rel) <= limits[1]
        checks["leaf_norms"] = max(leaf_rel.values()) <= limits[2]
        row_flips = {}
        if is_moe:
            n_flips, n_decisions = flips[name]
            checks["route_flips"] = (n_flips
                                     <= MOE_PARALLEL_FLIP_SHARE_MAX
                                     * n_decisions)
            row_flips = dict(route_flips=n_flips, route_decisions=n_decisions,
                             route_flip_share=n_flips / n_decisions,
                             flip_share_limit=MOE_PARALLEL_FLIP_SHARE_MAX)
        tokens = spec["global_batch"] * spec["seq"]
        step = float(np.mean(got["step_s"][1:]))
        one_step = float(np.mean(ref["step_s"][1:]))
        emit(dict(
            phase="parallel", layout=name, control=control, ranks=ranks,
            one_card_run_of=shared[name],
            axes=spec["axes"], n_layers=spec["layers"],
            global_batch=spec["global_batch"],
            micro_batch=spec.get("micro_batch", spec["global_batch"]),
            seq_len=spec["seq"],
            losses=got["losses"], one_card_losses=ref["losses"],
            grad_norms=got["grad_norms"],
            one_card_grad_norms=ref["grad_norms"],
            loss_rel=loss_rel, grad_norm_rel=norm_rel,
            leaf_norm_rel_max=max(leaf_rel.values()),
            leaf_norm_rel_worst=max(leaf_rel, key=leaf_rel.get),
            limits=limits, **row_flips,
            launches=[res["launches"] for res in runs],
            one_card_launches=ref["launches"],
            step_s=got["step_s"], step_s_mean_after_first=step,
            tokens_per_s=tokens / step, one_card_step_s=ref["step_s"],
            one_card_tokens_per_s=tokens / one_step,
            peak_memory_gb=[res["peak_memory_gb"] for res in runs],
            one_card_peak_memory_gb=ref["peak_memory_gb"],
            checks=checks,
            card=_card() if device == "cuda" else str(device),
            seconds=time.perf_counter() - t0))
        failed += [f"{name}:{k}" for k, ok in checks.items() if not ok]
    if failed and control is None:
        raise AssertionError(f"parallel: checks failed: {failed}")
    return failed


def _build_report(names=None):
    """Build the named kernels (default: all, and then the device timer
    beside them with the host compiler) and report, per library, what
    ``-Xptxas -v`` says (registers, shared memory, spills) and any compiler
    warning. A ``setmaxnreg`` that ptxas ignored (C7508) fails the run: the
    forward's consumer warpgroups would then run without the registers they
    take."""
    import threading

    from dlrover_tpu_torch.tpu_timer import build as timer_build

    t0 = time.perf_counter()
    timer = {}
    if names is None:
        def build_timer():
            try:
                paths = timer_build.build()
                timer.update(lib=paths["lib"].name,
                             daemon=paths["daemon"].name,
                             seconds=time.perf_counter() - t0)
            except RuntimeError as e:
                timer["error"] = str(e)

        timer_thread = threading.Thread(target=build_timer)
        timer_thread.start()
    libs = _build.build(names)
    info, warnings = {}, {}
    for name, path in libs.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        info[name] = [ln.replace("ptxas info    : ", "").strip()
                      for ln in lines if "Compiling entry" in ln
                      or "Used" in ln or "spill" in ln]
        warnings[name] = [ln.strip() for ln in lines
                          if "warning" in ln.lower() or "(C75" in ln]
    if names is None:
        timer_thread.join()
        if "error" in timer:
            raise AssertionError(f"the device timer did not build: "
                                 f"{timer['error']}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": info, "warnings": warnings, "timer": timer})
    ignored = [w for ws in warnings.values() for w in ws
               if "C7508" in w or "setmaxnreg ignored" in w]
    if ignored:
        raise AssertionError(f"ptxas ignored setmaxnreg: {ignored}")


_CARD = []


def _card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if not _CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        _CARD.append(smi.stdout.strip().splitlines()[0])
    return _CARD[0]


def _print_card():
    print(_card(), flush=True)


def main(argv) -> int:
    if argv[1:2] == ["--resume-child"]:
        return resume_child(json.loads(argv[2]))
    if argv[1:2] == ["--elastic-child"]:
        return elastic_child(json.loads(argv[2]))
    if argv[1:2] == ["--node-child"]:
        return node_child(json.loads(argv[2]))
    if argv[1:2] == ["--timer-child"]:
        return timer_child(json.loads(argv[2]))
    if argv[1:2] == ["--parallel-child"]:
        return parallel_child(json.loads(argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # flight-recorder bundles (this process's and its children's), removed
    # at exit
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    atexit.register(shutil.rmtree, trace_dir, True)
    os.environ["DLROVER_TPU_TRACE_DIR"] = trace_dir
    config = llama.LlamaConfig()
    decode_shape = (8, config.n_kv_heads, config.n_heads // config.n_kv_heads,
                    config.head_dim, 4096)
    if argv[1:2] == ["--multi"]:
        # the twin across the host's cards (see multi_phase); no result line
        ranks = int(argv[2]) if argv[2:] else torch.cuda.device_count()
        if ranks < 2 or torch.cuda.device_count() < ranks:
            print(f"chip_smoke --multi: needs {max(ranks, 2)} cards, has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        _build_report()
        root = os.path.join(REPO, ".chip_ckpt")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        try:
            multi_phase(dataclasses.replace(config, n_layers=2), device,
                        root, ranks, global_batch=8, seq=2048, steps=10,
                        storage_every=5, kill_at=4)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        _print_card()
        return 0
    if argv[1:2] == ["--parallel"]:
        # ring, Ulysses and GPipe across the host's cards against one
        # card; with --control NAME, that control's layout alone, exiting
        # 0 only when its readings failed and its launches held; no result
        # line
        control = argv[4] if argv[3:4] == ["--control"] else None
        ranks = int(argv[2]) if argv[2:] else torch.cuda.device_count()
        if (ranks != 4 or torch.cuda.device_count() < ranks
                or len(argv) not in (3, 5)
                or (len(argv) == 5 and control is None)):
            print(f"chip_smoke --parallel: takes 4 [--control NAME] and "
                  f"needs 4 cards, has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        _build_report(["flash_fwd", "flash_bwd"])
        failed = parallel_phase(ranks, control)
        _print_card()
        if control is not None:
            readings = ("losses", "grad_norms", "leaf_norms", "route_flips")
            allowed = readings + PARALLEL_CONTROL_ALSO_FAILS.get(control, ())
            kinds = [f.split(":")[1] for f in failed]
            if (not set(kinds) & set(readings)
                    or not set(kinds) <= set(allowed)):
                print(f"chip_smoke: control {control}: failed {failed}; "
                      "it must fail the readings against one card and "
                      f"nothing but {allowed}", file=sys.stderr)
                return 1
        return 0
    if argv[1:2] == ["--node-drill"]:
        # the node drill alone across the host's cards; no result line
        ranks = int(argv[2]) if argv[2:] else torch.cuda.device_count()
        if ranks < 2 or ranks % 2 or torch.cuda.device_count() < ranks:
            print(f"chip_smoke --node-drill: needs an even number of cards "
                  f"(>= 2), has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        _build_report()
        node_drill_alone(dataclasses.replace(config, n_layers=2), device,
                         ranks)
        _print_card()
        return 0
    if argv[1:] == ["--elastic"]:
        # phase 8 alone, held against its own unkilled run; no result line
        _build_report()
        elastic_alone(dataclasses.replace(config, n_layers=2), device)
        _print_card()
        return 0
    if argv[1:] == ["--copy-probe"]:
        # the replica store's frame copy, two buffers; no result line
        copy_probe()
        _print_card()
        return 0
    if argv[1:] == ["--timer-ab"]:
        # phase 6's child without and with the device timer; no result line
        root = os.path.join(REPO, ".chip_ckpt")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        try:
            timer_step_ab(dataclasses.replace(config, n_layers=2), device,
                          root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        _print_card()
        return 0
    if argv[1:] == ["--moe"]:
        # the MoE phase alone; no result line
        _build_report()
        moe_phase(device)
        _print_card()
        return 0
    if argv[1:3] == ["--moe", "--control"] and len(argv) == 4:
        # the MoE phase with one kernel made wrong; exits 0 only when every
        # check that runs that kernel failed; no result line
        _build_report()
        passed = moe_phase(device, control=argv[3])
        _print_card()
        if passed:
            print(f"chip_smoke: control {argv[3]}: {passed} passed with a "
                  f"wrong kernel", file=sys.stderr)
            return 1
        return 0
    if argv[1:] == ["--straggler"]:
        # the straggler leg alone; no result line
        _build_report()
        straggler_phase(device)
        _print_card()
        return 0
    if argv[1:] == ["--timer"]:
        # the device timer alone: the timer phase, no result line
        timer_phase(device)
        _print_card()
        return 0
    if argv[1:] == ["--serve"]:
        # the serving replica alone: phase 7, no result line
        _build_report()
        params = llama.init_params(
            config, torch.Generator(device=device).manual_seed(SEED), device)
        serve_phase(*serve_layers(params, config), device)
        _print_card()
        return 0
    if argv[1:] == ["--serve-elastic"]:
        # the elastic serving plane alone: phase 9, no result line
        _build_report()
        serve_elastic_phase(config, device)
        _print_card()
        return 0
    if argv[1:] == ["--fold"]:
        # the ring fold alone (see ring_fold_rows), no result line
        _build_report(["flash_fwd", "flash_bwd"])
        gen = torch.Generator(device=device).manual_seed(SEED)
        emit({"phase": "kernels", "ring_fold": ring_fold_rows(
            gen, device, (1, 32, 4 * 4096, 128), 4096)})
        _print_card()
        return 0
    if argv[1:2] == ["--tp-fold"]:
        # the tp fold alone (see tp_fold_rows), then each control of it;
        # no result line
        _build_report(["flash_fwd", "flash_bwd"])
        gen = torch.Generator(device=device).manual_seed(SEED)
        rows = {"tp_fold": tp_fold_rows(gen, device, config)}
        for control in TP_FOLD_CONTROLS:
            rows[f"tp_fold_{control}"] = tp_fold_rows(gen, device, config,
                                                      control)
        emit({"phase": "kernels", **rows})
        _print_card()
        passed = [n for n, r in rows.items()
                  if r["control"] and r["worst_rel"] <= TP_FOLD_REL_TOL]
        if passed:
            print(f"chip_smoke: tp fold controls {passed} within "
                  f"{TP_FOLD_REL_TOL}", file=sys.stderr)
            return 1
        return 0
    if argv[1:] == ["--decode"]:
        # K4 alone: its checks and times, no result line
        _build_report(["flash_decode"])
        gen = torch.Generator(device=device).manual_seed(SEED)
        emit({"phase": "kernels",
              **decode_kernel_rows(gen, device, decode_shape, 10)})
        _print_card()
        return 0
    _build_report()

    kernels = kernel_phase(device, fwd_shape=(8, 32, 2048, 128),
                           fwd_timed=((8, 32, 1024), (8, 32, 2048),
                                      (4, 32, 2048)),
                           bwd_shape=(4, 32, 2048, 128),
                           decode_shape=decode_shape,
                           fold_shape=(1, 32, 4 * 4096, 128),
                           tp_fold_config=config)
    torch.cuda.empty_cache()
    timer_phase(device)

    params = llama.init_params(
        config, torch.Generator(device=device).manual_seed(SEED), device)
    emit({"phase": "params", "num_params": llama.num_params(config),
          "bytes": sum(t.numel() * t.element_size()
                       for t in [*params["layers"].values(),
                                 params["tok_embed"], params["lm_head"],
                                 params["final_norm"]])})
    main_path = []
    main_path.append(generate_phase(
        params, config, device, "a", batch=8, prompt_len=1024, new=64,
        quantize=False, max_len=4096, timed_steps=16))
    torch.cuda.empty_cache()
    main_path.append(generate_phase(
        params, config, device, "b", batch=8, prompt_len=2048, new=32,
        quantize=True, max_len=None, timed_steps=16))
    torch.cuda.empty_cache()
    main_path.append(engine_phase(
        params, config, device, slots=8, cache_len=4096, n_requests=16,
        len_range=(100, 1500), new_range=(16, 48), n_teacher=4))
    torch.cuda.empty_cache()
    main_path.append(serve_phase(*serve_layers(params, config), device))
    del params  # the serving weights make room for the replicas and training
    torch.cuda.empty_cache()
    main_path.append(serve_elastic_phase(config, device))
    main_path.extend(moe_phase(device))
    counts, trained = train_phase(
        dataclasses.replace(config, n_layers=8), device, global_batch=8,
        micro_batch=4, seq=2048, steps=3, lr=3e-4)
    main_path.append(counts)
    ckpt_root = os.path.join(REPO, ".chip_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    os.makedirs(ckpt_root)
    try:
        main_path.append(ckpt_phase(trained, device, ckpt_root))
        del trained
        torch.cuda.empty_cache()
        counts, reference = resume_phase(
            dataclasses.replace(config, n_layers=2), device, ckpt_root,
            global_batch=8, seq=2048, steps=10, storage_every=5, kill_at=7)
        main_path.extend(counts)
        main_path.extend(elastic_phase(
            dataclasses.replace(config, n_layers=2), device, ckpt_root,
            global_batch=8, seq=2048, steps=10, storage_every=5,
            reference=reference,
            hang_downtime_s=hang_downtime_for(reference["max_gap_s"])))
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
        worker.shutdown()
    straggler_phase(device)

    replaces = {
        "flash_fwd": ("dlrover_tpu_torch/ops/csrc/flash_fwd.cu",
                      "dlrover_tpu/ops/flash_attention.py:98"),
        "flash_bwd_dq": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                         "dlrover_tpu/ops/flash_attention.py:212"),
        "flash_bwd_dkv": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                          "dlrover_tpu/ops/flash_attention.py:266"),
        "flash_decode_bf16": ("dlrover_tpu_torch/ops/csrc/flash_decode.cu",
                              "dlrover_tpu/ops/flash_attention.py:494"),
        "flash_decode_int8": ("dlrover_tpu_torch/ops/csrc/flash_decode.cu",
                              "dlrover_tpu/ops/flash_attention.py:494"),
    }
    rows = []
    for name, (source, tpu) in replaces.items():
        launches = sum(c[name] for c in main_path)
        if launches == 0:
            raise AssertionError(f"{name} never launched on the main path")
        k = kernels[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=tpu,
            launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            library=k["library"]))
        if "back_to_back_ms" in k:
            rows[-1]["back_to_back_ms"] = k["back_to_back_ms"]
    emit({"kernels": rows})
    _print_card()
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv)
    except Exception as e:
        # a failed check's message leads with what failed and may go on
        # with pages of a child's log: print its first line again last,
        # where the tail of the output shows it
        import traceback

        traceback.print_exc()
        head = str(e).split("\n", 1)[0]
        print(f"chip_smoke: failed: {type(e).__name__}: {head[:6000]}",
              file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)

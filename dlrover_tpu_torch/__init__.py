"""PyTorch/CUDA port of ``dlrover_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``dlrover_tpu`` stays in the repository as the reference;
this package grows beside it slice by slice and keeps its module names,
so each port module sits at the same relative path as its counterpart.
It imports ``torch`` and never ``jax``, and nothing of ``dlrover_tpu``.

Slice 1 is the Llama serving path: ``models/decode.py`` (prefill, KV-cache
decode, generate) and ``serving/engine.py`` (the batched continuous
decoding engine), carried by two hand-written CUDA kernels in
``ops/csrc/``: the flash-attention forward (prefill) and the single-token
decode attention over a bf16 or int8 cache.

Slice 2 is the training step: ``trainer/elastic.py`` (``ElasticTrainer``,
fixed global batch through grad-accum, f32 accumulators), ``trainer/optim.py``
(``adamw`` with optax's numbers), ``trainer/data.py`` (the elastic sampler
and loader), ``parallel/mesh.py`` (``plan_mesh``), the loss and per-layer
remat of ``models/llama.py``, and ``convert.train_state_from_jax``. The
flash-attention backward is two more hand-written kernels
(``ops/csrc/flash_bwd.cu``: dq, and dk/dv) behind a
``torch.autograd.Function``.

Slice 3 is the rest of the elastic pretraining loop: ``worker.py``
(``init`` on ``torch.distributed`` from the agent's environment, with
trimmed copies of the control-plane clients under ``agent/`` and
``common/``), ``parallel/sharding.py`` and ``parallel/mesh.py`` (the
reference's sharding rules as DTensor placements on a DeviceMesh), the
trainer across ranks, and Flash Checkpoint (``ckpt/``) in the reference's
frame format, so the JAX package's agent and engine read the port's frames
and the reverse.

Slices 4–9 are the serving replica, the agent and master, the elastic
serving plane and device observability. Slice 10 is Mixtral-class MoE:
``models/moe.py`` (routing, capacity, the aux loss, ``expert`` → ``ep``
sharding), its FFN in ``models/decode.py`` and ``serving/engine.py``, and
the MoE train step through ``ElasticTrainer``, on the same kernels.

Entry points take an explicit ``device`` (default ``"cuda"``) and never
fall back to the CPU on their own; the CPU tests pass ``device="cpu"``.
"""

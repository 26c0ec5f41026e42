"""Names of the agent's SharedDict through which workers publish progress
(the port's copy of the key constants of ``dlrover_tpu/agent/monitor.py``;
the agent's TrainingMonitor and ResourceMonitor read them)."""

TRAINING_METRICS_DICT = "training_metrics"
# per-local-rank device memory stats, "hbm/<local_rank>"
HBM_KEY_PREFIX = "hbm/"

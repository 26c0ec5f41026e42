"""The port's standing rules.

- ``dlrover_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of ``dlrover_tpu`` (checked on the source, and on
  ``sys.modules`` after importing every port module in a fresh
  interpreter);
- entry points default to the card and raise on a box without CUDA, never
  drifting to the CPU;
- the kernel build raises a clear error when ``nvcc`` is absent.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dlrover_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dlrover_tpu")


@pytest.mark.parametrize("path",
                         sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax_and_no_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_forbidden_prefix_spares_the_port_itself():
    assert _forbidden("dlrover_tpu.models.llama")
    assert _forbidden("dlrover_tpu")
    assert not _forbidden("dlrover_tpu_torch.models.llama")


def test_importing_every_port_module_leaves_jax_unloaded():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dlrover_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny():
    from dlrover_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the default device is usable")
    from dlrover_tpu_torch.models.decode import init_kv_cache
    from dlrover_tpu_torch.models.llama import init_params
    from dlrover_tpu_torch.serving.engine import BatchDecodeEngine

    c = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(c, torch.Generator())
    params = init_params(c, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchDecodeEngine(params, c, slots=2, cache_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_kv_cache(c, 2)
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticTrainer(None, None, 8, 4)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    from dlrover_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")


def test_build_knows_both_kernel_sources():
    from dlrover_tpu_torch.ops import _build

    assert set(_build.sources()) == {"flash_fwd", "flash_bwd",
                                     "flash_decode"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    name = _build.library_path("flash_fwd").name
    assert name.startswith("flash_fwd-") and name.endswith(".so")


def test_library_digest_sees_the_shared_headers(monkeypatch, tmp_path):
    """A kernel library is named by its source, the csrc headers and the
    flags, so an edited header rebuilds instead of loading a stale
    library; headers are not kernels of their own."""
    import shutil

    from dlrover_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    names = set(_build.sources())
    assert (src / "hopper.cuh").exists() and "hopper" not in names
    before = _build.library_path("flash_fwd")
    with open(src / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path("flash_fwd")
    assert after != before and after.name.startswith("flash_fwd-")
    assert set(_build.sources()) == names
    (src / "hopper.cuh").rename(src / "other.cuh")
    assert _build.library_path("flash_fwd") not in (before, after)


def test_launch_check_raises_on_cuda_error():
    from dlrover_tpu_torch.ops import _build

    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        _build.check(98, "k")

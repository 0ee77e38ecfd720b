"""Rules of the PyTorch port that hold for every module of it:

- it imports torch and numpy, never jax, flax, optax, orbax, grain or
  anything of tf_operator_tpu (an AST scan of every file, and a fresh
  process that imports every module and then looks at ``sys.modules``);
- ``chip_smoke.py`` refuses to run without a CUDA device and prints no
  result line;
- the CUDA kernels' sources are in the package, name the TPU kernels
  they replace and are built for sm_90a, every source together.
"""

import ast
import os
import re
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import tf_operator_tpu_torch
from tf_operator_tpu_torch.ops import _build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tf_operator_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "tf_operator_tpu")


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "chip_fault_probe.py",
                                           "chip_mp_witness.py", "chip_profile_probe.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            tf_operator_tpu_torch.__path__, "tf_operator_tpu_torch.")
    )


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    for m in ("models.batching", "ops.flash_attention", "ops.quant", "ops.quant_matmul",
              "ops.fused_batchnorm", "models.resnet", "resnet_dp", "parallel.trainer",
              "parallel.checkpoint", "runtime.harness", "data.text", "llama_pretrain",
              "utils.metrics", "utils.trace", "utils.logging", "utils.flight",
              "utils.alerts", "utils.costplane", "utils.watchdog", "runtime.telemetry",
              "models.pool_router", "models.fabric_service", "models.prefix_cache",
              "backend.retry", "serve_lm", "bootstrap.tpu_env", "runtime.bootstrap",
              "parallel.mesh", "parallel.sharding", "parallel.collectives", "models.mnist",
              "dist_psum", "dist_mnist", "dist_multislice", "ops.ring_attention",
              "ops.ulysses_attention", "models.bert", "models.t5", "models.vit",
              "bert_pretrain", "t5_multihost", "vit_classify", "models.gpt", "models.moe",
              "models.registry", "parallel.tensor_parallel", "models.lora",
              "models.pipelined_lm", "parallel.pipeline", "lora_finetune", "gpt_pipeline",
              "data.synthetic", "data.loader", "utils.summaries", "mnist_with_summaries"):
        assert f"tf_operator_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry,argv", [("lora_finetune", ["--base", "."]),
                                        ("gpt_pipeline", ["--pp", "1", "--steps", "1"])])
def test_the_lora_and_pipeline_entries_run_on_the_card_unless_asked(entry, argv):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUJOB_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", f"tf_operator_tpu_torch.{entry}", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "loss" not in proc.stdout


@pytest.mark.parametrize("entry,argv", [("dist_mnist", ["--data-dir", "D", "--steps", "1"]),
                                        ("mnist_with_summaries", ["--summary-dir", "D"])])
def test_the_mnist_entries_run_on_the_card_unless_asked(entry, argv, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUJOB_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    argv = [str(tmp_path / "d") if a == "D" else a for a in argv]
    proc = subprocess.run([sys.executable, "-m", f"tf_operator_tpu_torch.{entry}", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "loss" not in proc.stdout
    assert not os.path.exists(tmp_path / "d")


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_kernel_source_and_build_target():
    src = os.path.join(PKG, "csrc", "paged_attention.cu")
    with open(src) as f:
        text = f.read()
    assert "extern \"C\" int paged_attention_launch" in text
    assert "_paged_attn_kernel" in text  # names the TPU kernel it replaces
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.BUILD_DIR.endswith(os.path.join("build", "torch_kernels"))
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_flash_kernel_source_and_entry_points():
    src = os.path.join(PKG, "csrc", "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    for entry in ("flash_fwd_launch", "flash_bwd_dq_launch", "flash_bwd_dkv_launch"):
        assert f'extern "C" int {entry}' in text
    for tpu_kernel in ("_flash_kernel", "_flash_bwd_dq_kernel", "_flash_bwd_dkv_kernel"):
        assert tpu_kernel in text  # names the TPU kernel it replaces
    # the bf16 kernels are all on wgmma: the mma.sync design is gone
    assert "mma.sync.aligned" not in text and "wgmma.mma_async" in text
    # every source is built at first use, all nvcc processes together
    assert _build.sources() == ["flash_attention", "fused_batchnorm", "paged_attention",
                                "quant_matmul"]


def test_flash_hopper_kernels_run_wgmma_on_tma_stages():
    src = os.path.join(PKG, "csrc", "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    # K1, K2 and K3 are Hopper kernels: a producer warp's TMA loads into
    # an mbarrier ring, consumer warpgroups on wgmma, registers moved by
    # setmaxnreg, tensor maps encoded through the driver entry point
    for kernel in ("flash_fwd_hopper_kernel", "flash_bwd_dq_hopper_kernel",
                   "flash_bwd_dkv_hopper_kernel"):
        assert f"{kernel}<D>" in text
    for piece in ("wgmma.mma_async.sync.aligned.m64n", "cp.async.bulk.tensor.3d",
                  "mbarrier.try_wait.parity", "setmaxnreg.inc", "setmaxnreg.dec",
                  "cudaGetDriverEntryPoint", "const __grid_constant__ CUtensorMap"):
        assert piece in text, piece
    # the header names the TPU kernels they replace
    for line in (165, 297, 343):
        assert f"flash_attention.py:{line}" in text
    assert 'extern "C" int flash_hopper_smem_bytes' in text


def test_quant_matmul_kernel_source_and_entry_point():
    src = os.path.join(PKG, "csrc", "quant_matmul.cu")
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int quant_matmul_launch' in text
    # names the TPU kernel it replaces, and runs on the tensor cores
    assert "tf_operator_tpu/ops/quant_matmul.py::_kernel" in text
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    # split-K over a cluster (partials added through distributed shared
    # memory, no atomics); the weight and x staged in shared memory by
    # 16-byte asynchronous copies
    assert "cudaLaunchAttributeClusterDimension" in text and "map_shared_rank" in text
    assert "atomic" not in text.replace("no atomics", "") and not re.search(r"\bred\.", text)
    assert "cp.async.cg.shared.global [%0], [%1], 16" in text


def test_fused_batchnorm_kernel_source_and_entry_points():
    src = os.path.join(PKG, "csrc", "fused_batchnorm.cu")
    with open(src) as f:
        text = f.read()
    for entry in ("fused_batchnorm_fwd_launch", "fused_batchnorm_bwd_launch"):
        assert f'extern "C" int {entry}' in text
    # names the TPU kernels it replaces
    assert "tf_operator_tpu/ops/fused_batchnorm.py::_fwd_kernel" in text
    assert "tf_operator_tpu/ops/fused_batchnorm.py::_bwd_kernel" in text
    # hand-written: no library kernel behind it
    for library in ("cudnn", "cublas", "batch_norm", "torch", "cutlass"):
        assert library not in text.lower().replace("tf_operator_tpu_torch", "")


def test_paged_attention_kernel_splits_over_a_cluster_fed_by_a_ring():
    src = os.path.join(PKG, "csrc", "paged_attention.cu")
    with open(src) as f:
        text = f.read()
    # the context split across a thread-block cluster, partials through
    # distributed shared memory in rank order, no atomics
    assert "cudaLaunchAttributeClusterDimension" in text and "map_shared_rank" in text
    assert "atomic" not in text.replace("No atomics", "") and not re.search(r"\bred\.", text)
    # K and V through a ring of 16-byte asynchronous copies
    assert "cp.async.cg.shared.global [%0], [%1], 16" in text
    assert "cp.async.wait_group" in text and re.search(r"kStages = [2-9];", text)
    # the one-CTA-a-seat design is gone
    assert "paged_attention_kernel(" not in text and "paged_attention_split_kernel(" in text


def test_fused_batchnorm_backward_is_one_cooperative_launch():
    src = os.path.join(PKG, "csrc", "fused_batchnorm.cu")
    with open(src) as f:
        text = f.read()
    assert "cudaLaunchCooperativeKernel" in text and "grid.sync()" in text
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in text
    assert 'extern "C" int fused_batchnorm_bwd_resources' in text
    # the two-launch backward is gone, and so is K5's
    assert "bn_bwd_stats" not in text and "bn_bwd_apply" not in text
    assert "bn_fwd_stats" not in text and "bn_fwd_apply" not in text
    assert "atomic" not in text.replace("no atomics", "") and not re.search(r"\bred\.", text)


def test_fused_batchnorm_forward_is_one_cooperative_launch():
    src = os.path.join(PKG, "csrc", "fused_batchnorm.cu")
    with open(src) as f:
        text = f.read()
    # K5: one kernel through the cooperative launch on the grid from the
    # occupancy query, x held in shared memory between its sums and its
    # elementwise pass; no triple-chevron launch, no helper of the
    # two-launch design
    assert "bn_fwd_fused_kernel<T, kVecIO, kRelu, kRes>" in text
    assert "__launch_bounds__(kThreads, kCtasPerSm)\nbn_fwd_fused_kernel" in text
    assert 'extern "C" int fused_batchnorm_fwd_resources' in text
    assert "<<<" not in text
    for gone in ("reduce_partials", "chunk_rows", "TARGET_CTAS"):
        assert gone not in text
    body = text[text.index("bn_fwd_fused_kernel(") : text.index("\n// K6\n")]
    assert body.count("grid.sync()") == 2
    wrapper = os.path.join(PKG, "ops", "fused_batchnorm.py")
    with open(wrapper) as f:
        py = f.read()
    assert "chunk_rows" not in py and "TARGET_CTAS" not in py
    assert "fwd_resources(code" in py and "fwd_plan(r, c, ctas, hold" in py

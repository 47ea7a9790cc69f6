"""The port stands alone: no module of `videocof_torch`, not
`chip_smoke.py` and not the GPU tests (which run where JAX is absent) import
JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "videocof_tpu")
SOURCES = sorted((ROOT / "videocof_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_new_modules_are_covered():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"videocof_torch/models/lora.py",
            "videocof_torch/training/train_step.py",
            "videocof_torch/training/trainer.py",
            "videocof_torch/training/timestep_sampler.py",
            "videocof_torch/ops/int8_attention.py",
            "videocof_torch/models/teacache.py",
            "videocof_torch/schedulers/flow_euler.py",
            "videocof_torch/schedulers/flow_dpm.py",
            "videocof_torch/models/weights.py",
            "videocof_torch/utils/checkpoint.py",
            "videocof_torch/utils/colorspace.py",
            "videocof_torch/utils/video_io.py",
            "videocof_torch/data/instructions.py",
            "videocof_torch/factory.py",
            "videocof_torch/cli/_common.py",
            "videocof_torch/cli/fast_infer.py",
            "videocof_torch/cli/infer.py",
            "videocof_torch/models/wan_vae_streaming.py",
            "videocof_torch/pipeline/varlen.py",
            "videocof_torch/utils/fp8.py",
            "videocof_torch/models/wan_vae22.py",
            "videocof_torch/models/wan_vae22_streaming.py",
            "videocof_torch/pipeline/wan22_pipeline.py"} <= names


def test_pipeline_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'videocof_tpu'): sys.modules[m] = None\n"
            "import videocof_torch.pipeline.wan_pipeline\n"
            "import videocof_torch.convert\n"
            "import videocof_torch.models.lora\n"
            "import videocof_torch.training\n"
            "import videocof_torch.ops.int8_attention\n"
            "import videocof_torch.models.teacache\n"
            "import videocof_torch.schedulers.flow_euler\n"
            "import videocof_torch.schedulers.flow_dpm\n"
            "import videocof_torch.models.weights\n"
            "import videocof_torch.utils.checkpoint\n"
            "import videocof_torch.utils.video_io\n"
            "import videocof_torch.data.instructions\n"
            "import videocof_torch.factory\n"
            "import videocof_torch.cli.fast_infer\n"
            "import videocof_torch.cli.infer\n"
            "import videocof_torch.models.wan_vae_streaming\n"
            "from videocof_torch.pipeline import batch_edit\n"
            "import videocof_torch.utils.fp8\n"
            "import videocof_torch.models.wan_vae22_streaming\n"
            "from videocof_torch.pipeline import Wan22Pipeline\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

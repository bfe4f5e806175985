"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points default to the card and refuse to run without one."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "openmeasure_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_torch.py"]
# an import statement (or a dynamic import) of jax or the JAX package
_IMPORT = re.compile(
    r"^\s*(import\s+(jax|openmeasure_tpu)\b|from\s+(jax|openmeasure_tpu)\b"
    r"[.\w]*\s+import\b)|(import_module|__import__)\(\s*['\"](jax|openmeasure_tpu)",
    re.MULTILINE)


def test_import_without_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"          # any `import jax` now fails
        "import openmeasure_torch, openmeasure_torch.pipelines\n"
        "import openmeasure_torch.utils.convert, openmeasure_torch.utils.metrics\n"
        "import openmeasure_torch.utils.timing\n"
        "import openmeasure_torch.linalg.qrcp_cuda, openmeasure_torch._build\n"
        "import openmeasure_torch.linalg.chol, openmeasure_torch.linalg.chol_cuda\n"
        "import openmeasure_torch.gp.kernels, openmeasure_torch.gp.exact_gp\n"
        "import openmeasure_torch.gp.gpr, openmeasure_torch.core.host64\n"
        "import openmeasure_torch.linalg.boxls, openmeasure_torch.serving\n"
        "import openmeasure_torch.multifi.mfk, openmeasure_torch.multifi.cokriging\n"
        "import openmeasure_torch.sensing.gem, openmeasure_torch.sensing.dg\n"
        "import openmeasure_torch.sensing.vector, openmeasure_torch.sensing.decoder\n"
        "import openmeasure_torch.dynamics.dmd, openmeasure_torch.dynamics.kalman\n"
        "import openmeasure_torch.datasets.flame, openmeasure_torch.utils.logging\n"
        "import openmeasure_torch.ctc, openmeasure_torch.native\n"
        "import openmeasure_torch.linalg.incremental\n"
        "import openmeasure_torch.streaming, openmeasure_torch.utils.checkpoint\n"
        "from openmeasure_torch import StreamingSPR, StreamingDMD\n"
        "import openmeasure_torch.parallel.sharded\n"
        "import openmeasure_torch.parallel.harness\n"
        "from openmeasure_torch.ctc import (camera, grid, projection, raytrace,\n"
        "                                  resample, unstructured)\n"
        "bad = [m for m in sys.modules if m == 'openmeasure_tpu'\n"
        "       or m.startswith(('jax.', 'openmeasure_tpu.'))]\n"
        "assert sys.modules['jax'] is None and not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    assert path.exists(), path
    hits = _IMPORT.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None legitimately runs there")
    from openmeasure_torch import GPR, SPR
    from openmeasure_torch.pipelines import gpr_end_to_end, spr_end_to_end
    X = np.random.default_rng(0).standard_normal((40, 6)) + 5.0
    P = np.random.default_rng(1).standard_normal((6, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spr_end_to_end(X, X[:, :2], n_features=2, r=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPR(X, 2, np.zeros((20, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpr_end_to_end(X, P, P[:2], X[:, :2], n_features=2, r=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPR(X, 2, np.zeros((20, 3)), P)
    # the sharded entry points: make_mesh() means the card (NCCL)
    from openmeasure_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    from openmeasure_torch import SoftSensor
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SoftSensor(X[:, :3], X[:3, :3], np.zeros(3), np.ones(3),
                   np.zeros(40), np.ones(40))
    from openmeasure_torch import PIGPR, CoKriging, MultiFiCoKriging
    from openmeasure_torch.pipelines import mfk_end_to_end
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfk_end_to_end(P, X[:2, :6], P[:3], X[:2, :3], P[:2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoKriging(P[:3], P[3:], X[:, :3], X[:, 3:], X[:, :3],
                  np.zeros((20, 3)), np.zeros((20, 3)), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiFiCoKriging()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PIGPR(X, 2, np.zeros((20, 3)), P, P[:2], None)
    from openmeasure_torch import (DMD, DecoderSensor, DynamicSensor,
                                   ShallowDecoder)
    from openmeasure_torch.sensing.vector import vector_onehot
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShallowDecoder(X, 2, np.zeros((20, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DMD(X, 2, np.zeros((20, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderSensor([(np.zeros((3, 4)), np.zeros(4))], np.zeros(3),
                      np.ones(3), np.zeros(4), np.ones(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynamicSensor(X[:, :3], X[:3, :3], np.zeros(3), np.ones(3),
                      np.zeros(40), np.ones(40), np.eye(3), np.eye(3),
                      np.zeros(3), np.eye(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vector_onehot([0, 2], 2, 20)
    from openmeasure_torch.ctc import VoxelGrid, resample_to_grid
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoxelGrid((0, 0, 0), (1, 1, 1), (2, 2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoxelGrid.from_bounds((0, 1, 0, 1, 0, 1), (2, 2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resample_to_grid(np.random.default_rng(2).random((20, 3)),
                         np.ones((20, 1)), [3, 3, 3])
    from openmeasure_torch import (StreamingDMD, StreamingGPR,
                                   StreamingPIGPR, StreamingSPR)
    from openmeasure_torch.utils.checkpoint import load_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSPR(X, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingDMD(X, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingGPR(X, 2, None, P)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingPIGPR(X, 2, None, P, P[:2], None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("model.npz")


def test_port_reads_no_file_of_the_jax_package():
    """The port's sources name no path inside the JAX package: its native
    build compiles its own copies of the ray caster and the loader."""
    from openmeasure_torch import _build
    assert _build.NATIVE == ROOT / "openmeasure_torch" / "native"
    assert (_build.NATIVE / "raycast.cpp").is_file()
    assert (_build.NATIVE / "npyloader.cpp").is_file()
    for path in PORT_FILES:
        text = path.read_text()
        # a path into the JAX package, as a string or joined with `/`
        assert "openmeasure_tpu/native" not in text, path
        assert 'openmeasure_tpu" /' not in text, path

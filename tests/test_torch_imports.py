"""The port stands alone: no module of ``hybridgl_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or the JAX package
``hybridgl_tpu``.

Two checks. The import check runs in a subprocess whose ``sys.meta_path``
refuses those three packages, and imports every module of the port (a walk
of the package) or ``chip_smoke`` as a module. The source scan reads every
file of the port, one case per subpackage, and finds no import statement
naming them.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hybridgl_tpu_torch")

_REFUSE = '''
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hybridgl_tpu"):
            raise ImportError(f"refused in this test: {name}")

sys.meta_path.insert(0, Refuse())
'''

_WALK = '''
import importlib, pkgutil, sys
import torch
TORCH_ALONE = set(sys.modules)  # what "import torch" brings by itself
import hybridgl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hybridgl_tpu_torch.__path__, "hybridgl_tpu_torch.")]
assert len(names) > 40, names
for new in ("models.sam.predictor", "models.clip.resnet", "models.clip.preprocess", "pipeline.visual_prompts",
            "utils.flops", "utils.buckets", "parallel.mesh", "parallel.full_eval",
            "parallel.encoder_tp", "parallel.launch", "parallel.workers", "tools.dryrun", "tools.bench",
            "tools.profile_proposals", "tools.profile_multicrop", "tools.profile_trace", "tools.compare_parity",
            "tools.dump_reference_parity", "tools.flops_audit", "tools.probe_dp_cleanup"):
    assert "hybridgl_tpu_torch." + new in names, new
import sys
import hybridgl_tpu_torch.pipeline.runner, hybridgl_tpu_torch.cli.main
assert "torch.distributed" not in sys.modules or "torch.distributed" in TORCH_ALONE, "the serving modules import torch.distributed"
for name in names:
    importlib.import_module(name)
'''

_TARGETS = {"package": _WALK, "chip_smoke": "import chip_smoke\n"}


@pytest.mark.parametrize("target", sorted(_TARGETS))
def test_imports_with_jax_and_reference_refused(target):
    code = _REFUSE + _TARGETS[target] + "assert not {'jax', 'jaxlib', 'hybridgl_tpu'} & set(sys.modules)\n"
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-3000:]


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|hybridgl_tpu)(?:[\s.]|$)", re.M)
_DYNAMIC = re.compile(r"import_module\(\s*[\"'](?:jax|jaxlib|hybridgl_tpu)[\"'.]|__import__\(\s*[\"'](?:jax|jaxlib|hybridgl_tpu)[\"'.]")
# one case per subpackage; "" is the package's top level
_SUBPACKAGES = ("", "cli", "core", "data", "eval", "kernels", "lang", "models", "parallel", "pipeline", "tools", "utils")


def _sources(sub):
    top = os.path.join(PORT, sub)
    if sub == "":
        return [os.path.join(top, f) for f in sorted(os.listdir(top)) if f.endswith(".py")]
    return [os.path.join(d, f) for d, _, files in sorted(os.walk(top)) for f in sorted(files) if f.endswith(".py")]


@pytest.mark.parametrize("sub", _SUBPACKAGES + ("chip_smoke.py",))
def test_sources_name_no_jax_import(sub):
    paths = [os.path.join(REPO, sub)] if sub == "chip_smoke.py" else _sources(sub)
    assert paths, sub
    for path in paths:
        with open(path) as f:
            text = f.read()
        hit = _IMPORT.search(text) or _DYNAMIC.search(text)
        assert hit is None, f"{os.path.relpath(path, REPO)}: {hit.group(0).strip()!r}"


def test_every_subpackage_is_scanned():
    subs = {d for d in os.listdir(PORT) if os.path.isfile(os.path.join(PORT, d, "__init__.py"))}
    assert subs == set(_SUBPACKAGES) - {""}

"""``hybridgl_tpu_torch/tools/export_serving.py`` on the CPU: the SAM encoder
(at a geometry whose windowed block reaches K1 and whose global block K2)
and the G2L fusion over the tiny CLIP (K6) exported with ``torch.export``.
Each graph holds the ``torch.ops.hybridgl`` nodes and no decomposition of
them (no softmax node: the kernels' plain versions are the stages' only
softmax); the saved and reloaded programs equal the eager port exactly and
match the JAX package's ``encode_image`` and ``hybrid_forward`` to 1e-4, the
bar of tests/test_torch_sam.py and tests/test_torch_clip_gem.py (f32, the
same numpy-seeded weights and inputs; the JAX side runs its Pallas kernels
in interpret mode). A fresh process that imports only the port loads both
files, and ``main`` writes them at the miniature presets.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybridgl_tpu.core.config import PipelineConfig as JaxPipelineConfig
from hybridgl_tpu.core.config import clip_preset
from hybridgl_tpu.core.params import init_clip as jax_init_clip
from hybridgl_tpu.models.clip.fusion import hybrid_forward as jax_hybrid_forward
from hybridgl_tpu.models.sam.image_encoder import encode_image as jax_encode_image
from hybridgl_tpu_torch.core.params import from_numpy_tree
from hybridgl_tpu_torch.models.sam.image_encoder import prepare_sam_params
from hybridgl_tpu_torch.tools import export_serving

from test_torch_imports import _REFUSE
from test_torch_sam import ROUTING, jax_tree, noisy_params
from torch_port_config import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
P = 4


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The two stages exported and saved at the JAX config's port: (cfg, weights, inputs, programs, paths)."""
    jcfg = JaxPipelineConfig(sam_config=ROUTING, clip_config=clip_preset("test-tiny"))
    cfg = to_port(jcfg)
    sam_np = noisy_params(ROUTING, 0)["encoder"]
    rng = np.random.default_rng(3)
    clip_np = jax.tree_util.tree_map(np.asarray, jax_init_clip(jax.random.PRNGKey(1), jcfg.clip))["visual"]
    clip_np = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32) if x.ndim == 1 and not x.any() else np.array(x),
        clip_np)
    S = cfg.clip.image_size
    inputs = dict(image=rng.standard_normal((1, cfg.sam.img_size, cfg.sam.img_size, 3)).astype(np.float32),
                  local=rng.standard_normal((P, S, S, 3)).astype(np.float32),
                  glob=rng.standard_normal((P, S, S, 3)).astype(np.float32),
                  masks=(rng.random((P, S, S)) > 0.6).astype(np.float32))
    inputs["masks"][2] = 0.0  # an empty proposal
    enc = prepare_sam_params({"encoder": from_numpy_tree(sam_np)}, cfg.sam)["encoder"]
    visual = from_numpy_tree(clip_np)
    programs = {"sam_encoder": export_serving.export_encoder(cfg, enc, "cpu"),
                "hybrid_fusion": export_serving.export_fusion(cfg, visual, P, "cpu")}
    root = tmp_path_factory.mktemp("exported")
    paths = {k: str(root / f"{k}.pt2") for k in programs}
    for k, program in programs.items():
        torch.export.save(program, paths[k])
    return (jcfg, cfg), (sam_np, clip_np, enc, visual), inputs, programs, paths


def run(name, program_or_module, weights, inputs):
    _, _, enc, visual = weights
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    if name == "sam_encoder":
        return program_or_module(enc, t["image"])
    return program_or_module(visual, t["local"], t["glob"], t["masks"])


def eager(name, cfg):
    if name == "sam_encoder":
        return export_serving.SamEncoder(cfg.sam)
    return export_serving.HybridFusion(cfg.clip, cfg.fusion_mode, export_serving.fusion_masking_block(cfg))


# G2L at masking block 1 of 3 layers: block 0 on the fused 2P batch, then two
# streams through blocks 1 and 2, each block call one K6 with its head split
# and merge and one bias + QuickGELU (the chip smoke test's K6 count, 15 at
# ViT-B/16). LayerNorm alone: the two stems' ln_pre, block 0's ln_1, ln_post.
# The rest is written with the residual that it normalises: each block's
# ln_2, the trunk's and the global stream's next ln_1 (2 + 4 + 1), and
# G2L's injection with the local stream's ln_1 (2); a residual alone ends
# the local stream's blocks and the global stream's last (3).
FUSION_NODES = {"clip_attention": 5, "qkv_heads": 5, "merge_heads": 5, "bias_quick_gelu": 5, "layer_norm": 4,
                "residual_layer_norm": 7, "inject_layer_norm": 2, "residual_add": 3}
# the encoder's two blocks, one windowed (K1) and one global (K2), with the SAM glue around them: block 0's
# ln_1 alone; a block's qkv heads, merge, out-projection residual + ln_2 and bias + GELU; block 0's MLP
# residual with block 1's ln_1, block 1's alone
ENCODER_NODES = {"flash_windowed_fused": 1, "flash_attention_fused": 1, "sam_layer_norm": 1, "sam_qkv_heads": 2,
                 "sam_merge_heads": 2, "sam_residual_layer_norm": 3, "sam_residual_add": 1, "sam_bias_gelu": 2}


@pytest.mark.parametrize("name,nodes", [("sam_encoder", ENCODER_NODES), ("hybrid_fusion", FUSION_NODES)])
def test_graph_holds_the_kernel_operators(exported, name, nodes):
    """Encoder: one windowed and one global block (``ENCODER_NODES``); the fusion: ``FUSION_NODES``."""
    _, _, _, programs, _ = exported
    assert export_serving.kernel_nodes(programs[name]) == nodes
    targets = {str(n.target) for n in programs[name].graph.nodes if n.op == "call_function"}
    assert not [t for t in targets if "softmax" in t], targets


@pytest.mark.parametrize("name", ["sam_encoder", "hybrid_fusion"])
def test_reloaded_program_equals_eager_and_jax(exported, name):
    (jcfg, cfg), weights, inputs, programs, paths = exported
    want = run(name, eager(name, cfg), weights, inputs)
    got = run(name, programs[name].module(), weights, inputs)
    program = export_serving.load_exported(paths[name])
    assert program.example_inputs is None  # the file holds the program, not the weights it was traced with
    reloaded = run(name, program.module(), weights, inputs)
    assert torch.equal(got, want) and torch.equal(reloaded, want)
    sam_np, clip_np, _, _ = weights
    if name == "sam_encoder":
        ref = jax_encode_image(jax_tree(sam_np), jnp.asarray(inputs["image"]), jcfg.sam)
    else:
        ref = jax_hybrid_forward(jax_tree(clip_np), jnp.asarray(inputs["local"]), jnp.asarray(inputs["glob"]),
                                 jnp.asarray(inputs["masks"]), jcfg.clip, fusion_mode=jcfg.fusion_mode,
                                 masking_block=export_serving.fusion_masking_block(cfg))
    assert reloaded.shape == ref.shape and torch.isfinite(reloaded).all()
    assert np.abs(reloaded.numpy() - np.asarray(ref)).max() <= TOL


def test_fresh_process_loads_with_only_the_port(exported, tmp_path):
    """The loading process refuses jax and the JAX package and imports the
    port alone; both programs load with their kernel nodes, and the fusion
    run there equals the eager port here."""
    (_, cfg), weights, inputs, _, paths = exported
    fusion_args = (weights[3], *(torch.from_numpy(inputs[k]) for k in ("local", "glob", "masks")))
    torch.save(fusion_args, tmp_path / "args.pt")
    code = _REFUSE + f'''
import torch
from hybridgl_tpu_torch.tools.export_serving import kernel_nodes, load_exported
enc, fus = load_exported({paths["sam_encoder"]!r}), load_exported({paths["hybrid_fusion"]!r})
assert kernel_nodes(enc) == {ENCODER_NODES!r}, kernel_nodes(enc)
assert kernel_nodes(fus) == {FUSION_NODES!r}, kernel_nodes(fus)
torch.save(fus.module()(*torch.load({str(tmp_path / "args.pt")!r})), {str(tmp_path / "out.pt")!r})
assert not {{"jax", "jaxlib", "hybridgl_tpu"}} & set(sys.modules)
'''
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert torch.equal(torch.load(tmp_path / "out.pt"), eager("hybrid_fusion", cfg)(*fusion_args))


def test_main_writes_both_programs(tmp_path, capsys):
    export_serving.main(["--out-dir", str(tmp_path), "--sam", "test-tiny", "--clip", "test-tiny", "--proposals", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    for name in ("sam_encoder", "hybrid_fusion"):
        path = tmp_path / f"{name}.pt2"
        assert path.exists() and path.stat().st_size > 0
        assert any(line.startswith(name.replace("_", " ")) and str(path) in line for line in out)

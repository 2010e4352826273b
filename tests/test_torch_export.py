"""AOT export of the port (radzero_torch.eval.export) on the CPU, where the
registered ops run the kernels' plain twins.

- the loaded program against the port's compute_logits (bit for bit) and
  against the JAX compute_logits on the same weights (the repo's gate:
  logits rtol 1e-3 / atol 2e-4, map MAE < 1e-3, tests/test_radzero_model.py);
- the exported graph holds the ``radzero::`` ops of K1-K5 (default) and
  K13 / K15 (``fused_tower=False`` with ``TextConfig(attn_impl="flash")``);
- eager calls never enter the op dispatcher;
- a bundle cold-starts ``ServingEngine.from_bundle`` in a fresh interpreter
  and answers with the live engine's probabilities.

Sizes as tests/test_torch_slice.py: D = 64, 2 tower + 2 align + 2 text
layers, 4 heads, positions stored for 42 px and run at 56 px.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.export import export_zero_shot, load_zero_shot, own_stack_chunk
from radzero_torch.eval.serving import ImageSpec, ServingEngine
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.models.radzero import compute_logits
from radzero_torch.ops import flash_attention as fa
from radzero_torch.ops import fused_layer as fl
from radzero_torch.ops import registry
from radzero_torch.ops import vlcabs_fused as vf
from radzero_torch.ops.layers import normalize_pixels

from test_torch_modules import TEXT, VIT, perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64


def _cfg(m, **text):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),
        text=m.TextConfig(**{**TEXT, **text}),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


JCFG, TCFG = _cfg(jconf), _cfg(tconf)
FLASH = _cfg(tconf, attn_impl="flash")
# kernel -> the op name in the graph
DEFAULT_OPS = {f"radzero.{registry.OPS[k]}.default" for k in ("K1", "K2", "K3", "K4", "K5")}
FLASH_OPS = {f"radzero.{registry.OPS[k]}.default" for k in ("K13", "K15")}


@pytest.fixture(scope="module")
def weights():
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), JCFG), np.random.default_rng(0))
    return tree, params_from_jax(tree)


def _inputs(seed=1, b=2, n=3, l=12):
    rng = np.random.default_rng(seed)
    pv = rng.standard_normal((b, 56, 56, 3)).astype(np.float32)
    ids = np.full((n, l), 1, np.int64)
    mask = np.zeros((n, l), np.int64)
    for i in range(n):
        k = int(rng.integers(4, l + 1))
        ids[i, :k] = rng.integers(3, 211, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    return pv, ids, mask


def _graph_ops(bundle):
    program = torch.export.load(os.path.join(bundle, "zero_shot.pt2"))
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("radzero.")}


@pytest.fixture(scope="module")
def bundle_fp32(weights, tmp_path_factory):
    _, params = weights
    out = str(tmp_path_factory.mktemp("fp32"))
    return export_zero_shot(params, TCFG, out, batch_size=2, n_prompts=3, max_tokens=12,
                            dtype=torch.float32, device="cpu")


def test_export_roundtrip_matches_port_and_jax(weights, bundle_fp32):
    tree, params = weights
    runner, meta = load_zero_shot(bundle_fp32)
    assert meta["batch_size"] == 2 and meta["img_size"] == 56 and meta["device"] == "cpu"
    assert meta["fused_tower"] is True and meta["dtype"] == "float32"
    assert meta["torch"] == torch.__version__
    pv, ids, mask = _inputs()
    args = (torch.from_numpy(pv), torch.from_numpy(ids), torch.from_numpy(mask))
    logits, scores = runner(*args)
    ref = compute_logits(params, TCFG, *args)
    assert logits.shape == (2, 3) and scores.shape == (2, 3, 16)
    torch.testing.assert_close(logits, ref["logits"], rtol=0, atol=0)
    torch.testing.assert_close(scores, ref["similarity_scores"], rtol=0, atol=0)

    jref = jax_compute_logits(tree, jconf.with_fused_towers(JCFG), jnp.asarray(pv),
                              jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jref["logits"]), rtol=1e-3,
                               atol=2e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jref["similarity_scores"]),
                               rtol=1e-3, atol=2e-4)
    assert np.abs(scores.numpy() - np.asarray(jref["similarity_scores"])).mean() < 1e-3


def _launches():
    return {f.__name__: f.launches for f in (
        fl.fused_preattn, fl.flash_attention_packed, fl.fused_postattn, fl.fused_mpnet_post,
        vf.vlcabs_fused, fa.flash_attention, fa.flash_attention_bias)}


def test_graph_holds_the_serving_ops(bundle_fp32):
    assert _graph_ops(bundle_fp32) == DEFAULT_OPS


def test_flash_graph_holds_k13_and_k15(weights, tmp_path):
    """fused_tower=False with TextConfig(attn_impl="flash"): the tower on
    K13, MPNet on K15 and K4, the align layers on K1-K3, VL-CABS on K5; the
    program is bit-equal to compute_logits(fused_towers=False)."""
    _, params = weights
    bundle = export_zero_shot(params, FLASH, str(tmp_path), batch_size=2, n_prompts=3,
                              max_tokens=12, dtype=torch.float32, device="cpu",
                              fused_tower=False)
    assert _graph_ops(bundle) == DEFAULT_OPS | FLASH_OPS
    runner, meta = load_zero_shot(bundle)
    assert meta["fused_tower"] is False
    args = tuple(torch.from_numpy(a) for a in _inputs(seed=2))
    logits, scores = runner(*args)
    ref = compute_logits(params, FLASH, *args, fused_towers=False)
    torch.testing.assert_close(logits, ref["logits"], rtol=0, atol=0)
    torch.testing.assert_close(scores, ref["similarity_scores"], rtol=0, atol=0)


def test_program_runs_each_op_once_per_kernel_call(bundle_fp32):
    """One program run enters each op body as often as compute_logits calls
    the kernel's wrapper (2 tower + 2 align layers on K1-K3, each MPNet
    layer on K4, one VL-CABS). The body calls the wrapper, which counts a
    launch only where it launches the kernel: on the card the program's
    counts are the eager call's (chip_smoke.py, tests/test_torch_cuda.py);
    here the twins run and count none."""
    runner, _ = load_zero_shot(bundle_fp32)
    registry.reset_calls()
    before = _launches()
    runner(*(torch.from_numpy(a) for a in _inputs(seed=3)))
    k4 = TCFG.text.num_hidden_layers if TCFG.text.fuse_post else 0
    assert registry.calls == {"fused_preattn": 4, "flash_attention_packed": 4,
                              "fused_postattn": 4, "fused_mpnet_post": k4, "vlcabs_fused": 1,
                              "flash_attention": 0, "flash_attention_bias": 0}
    assert _launches() == before


def test_eager_calls_do_not_enter_the_dispatcher(weights):
    """Outside torch.export the wrappers never reach their ops: a direct
    call of each wrapper, and a whole compute_logits, leave every op's own
    count at zero."""
    _, params = weights
    registry.reset_calls()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(10, D, generator=g)
    ones, zeros = torch.ones(D), torch.zeros(D)
    fl.fused_preattn(x, ones, zeros, torch.randn(D, 3 * D, generator=g), torch.zeros(3 * D))
    fl.flash_attention_packed(torch.randn(2, 5, 3 * D, generator=g), 4)
    q = torch.randn(2, 5, 4, 16, generator=g)
    fa.flash_attention(q, q, q)
    fa.flash_attention_bias(q, q, q, torch.zeros(4, 5, 5), torch.zeros(2, 5))
    vf.vlcabs_fused(torch.nn.functional.normalize(torch.randn(3, D, generator=g), dim=-1),
                    torch.randn(2, 5, D, generator=g), torch.tensor([0.07]))
    compute_logits(params, FLASH, *(torch.from_numpy(a) for a in _inputs()))
    assert registry.calls == {name: 0 for name in registry.calls}
    assert not torch.compiler.is_exporting()


def test_forward_starts_a_stack_chunk_of_its_own(bundle_fp32):
    """own_stack_chunk gives the loaded program's forward a frame larger than
    CPython's first 16 KiB data-stack chunk (so every call starts a chunk of
    its own), on that module alone, and the program's answers keep their bits."""
    def words(module):
        code = type(module).forward.__code__
        return (code.co_nlocals + len(code.co_cellvars) + len(code.co_freevars)
                + code.co_stacksize)

    program = torch.export.load(os.path.join(bundle_fp32, "zero_shot.pt2"))
    plain, grown = program.module(), own_stack_chunk(program.module())
    assert words(plain) < 2048 < words(grown)
    assert words(program.module()) == words(plain)
    args = tuple(torch.from_numpy(a) for a in _inputs(seed=4))
    for a, b in zip(plain(*args), grown(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_load_refuses_another_device(bundle_fp32):
    with pytest.raises(ValueError, match="exported on cpu"):
        load_zero_shot(bundle_fp32, device="cuda")


def _jpegs(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (64 + 8 * i, 50), dtype=np.uint8), "L").save(
            buf, "JPEG", quality=95)
        out.append(buf.getvalue())
    return out


PROMPTS = ["There is Edema", "There is Pneumothorax", "No Finding"]

COLD_START = """
import json, sys
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.serving import ServingEngine
bundle, files, prompts = sys.argv[1], sys.argv[2:-1], json.loads(sys.argv[-1])
tok = WhitespaceHashTokenizer(vocab_size=211, max_length=12)
jpegs = [open(f, "rb").read() for f in files]
with ServingEngine.from_bundle(bundle, tok, max_delay_ms=500, preprocess_threads=2) as engine:
    assert engine.max_batch == 2 and engine.channels == 1 and engine.device.type == "cpu"
    engine.register_prompt_set("cls", prompts)
    futs = [engine.submit(j, "cls", want_maps="patch") for j in jpegs]
    out = [f.result(timeout=300) for f in futs]
print(json.dumps({"probs": [o["probs"].tolist() for o in out],
                  "maps": [o["similarity_maps"].tolist() for o in out],
                  "modules": sorted(m for m in sys.modules if m.split(".")[0] in
                                    ("jax", "radzero_tpu"))}))
"""


def test_bundle_cold_starts_serving_engine_in_a_fresh_process(weights, tmp_path):
    """A uint8 grayscale bundle, loaded by ServingEngine.from_bundle in a
    new interpreter (nothing of this process, no JAX), answers JPEG bytes
    with the live engine's probabilities and maps; the third request rides
    a batch padded to the bundle's 2."""
    _, params = weights
    bundle = export_zero_shot(params, TCFG, str(tmp_path / "u8"), batch_size=2, n_prompts=3,
                              max_tokens=12, dtype=torch.float32, from_uint8=True, channels=1,
                              device="cpu")
    meta = json.load(open(os.path.join(bundle, "bundle.json")))
    assert meta["from_uint8"] and meta["channels"] == 1
    assert meta["image_mean"] == list(ImageSpec().mean)
    jpegs = _jpegs(3)
    files = []
    for i, data in enumerate(jpegs):
        files.append(str(tmp_path / f"{i}.jpg"))
        with open(files[-1], "wb") as f:
            f.write(data)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", COLD_START, bundle, *files, json.dumps(PROMPTS)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    assert cold["modules"] == []

    tok = WhitespaceHashTokenizer(vocab_size=211, max_length=12)
    with ServingEngine(params, TCFG, tok, device="cpu", dtype=torch.float32, max_batch=2,
                       channels=1, max_delay_ms=500, preprocess_threads=2) as live:
        live.register_prompt_set("cls", PROMPTS)
        ref = [live.submit(j, "cls", want_maps="patch").result(timeout=300) for j in jpegs]
    for i, r in enumerate(ref):
        # the serving tolerance of tests/test_torch_slice.py (the live engine
        # runs the short batch at its own size, the bundle at 2)
        np.testing.assert_allclose(cold["probs"][i], r["probs"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(cold["maps"][i], r["similarity_maps"], rtol=1e-5, atol=1e-6)


def test_from_bundle_checks_batch_and_prompt_shape(weights, bundle_fp32):
    tok = WhitespaceHashTokenizer(vocab_size=211, max_length=12)
    with pytest.raises(ValueError, match="exported at batch 2"):
        ServingEngine.from_bundle(bundle_fp32, tok, max_batch=4)
    with ServingEngine.from_bundle(bundle_fp32, tok) as engine:
        assert engine.dtype == torch.float32 and engine.params is None
        with pytest.raises(ValueError, match="prompt ids"):
            engine.register_prompt_set("two", PROMPTS[:2])
        engine.register_prompt_set("cls", PROMPTS)
        img = np.random.default_rng(0).integers(0, 256, (56, 56, 3), dtype=np.uint8)
        got = engine.submit(img, "cls", want_maps="patch").result(timeout=120)
    # a float bundle: the engine normalises on the host side of the program
    u8 = torch.from_numpy(img)[None]
    pv = normalize_pixels(u8, ImageSpec().mean, ImageSpec().std, dtype=torch.float32)
    ids, mask = (torch.as_tensor(a).long() for a in tok(PROMPTS))
    ref = compute_logits(weights[1], TCFG, pv, ids, mask)
    np.testing.assert_allclose(got["probs"], torch.sigmoid(ref["logits"][0]).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_export_refuses_grey_without_uint8(weights, tmp_path):
    with pytest.raises(ValueError, match="channels=1 requires from_uint8"):
        export_zero_shot(weights[1], TCFG, str(tmp_path), channels=1, device="cpu",
                         dtype=torch.float32)


def test_fused_tower_none_resolves_to_true(weights, tmp_path):
    cfg = dataclasses.replace(TCFG, vision=dataclasses.replace(TCFG.vision, attn_impl="flash"))
    bundle = export_zero_shot(weights[1], cfg, str(tmp_path), batch_size=1, n_prompts=3,
                              max_tokens=12, dtype=torch.float32, device="cpu")
    assert json.load(open(os.path.join(bundle, "bundle.json")))["fused_tower"] is True
    assert _graph_ops(bundle) == DEFAULT_OPS

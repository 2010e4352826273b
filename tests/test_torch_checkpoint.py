"""The real-checkpoint path of the port on the CPU: its safetensors reader and
writer, the HF-snapshot converter against the JAX converter, compute_logits on
converted weights against the JAX package, and the runbook's and the
server's command lines on a converted checkpoint.

Snapshots are HF models at toy sizes (D = 64, 2 tower + 2 align + 2 text
layers, 4 heads, a 3 x 3 position table run at 56 px) built with
``transformers`` from a seed and written in the exact on-disk layout of a
hub snapshot (``model.safetensors``; ``save_pretrained`` for the tower
kinds), as tests/test_convert_real_layout.py does for the JAX package.
Tests that need ``transformers`` or ``safetensors`` skip without them.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from radzero_tpu.data.processing import BlipStyleImageProcessor as JaxProcessor
from radzero_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from radzero_tpu.eval.api import model_inference as jax_model_inference
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models import convert as jconvert
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_torch.data.tokenizer import WordPieceTokenizer
from radzero_torch.eval.serving import ImageSpec, ServingEngine
from radzero_torch.models import configuration as tconf
from radzero_torch.models.convert import to_hf_state_dict
from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
from radzero_torch.models.radzero import compute_logits, init_radzero
from radzero_torch.tools import convert_checkpoint as tool
from radzero_torch.tools import run_real_checkpoint as runbook
from radzero_torch.utils import safetensors_io

from test_torch_modules import TEXT, VIT
from test_torch_server import _get, _jpeg, _post, _same, _server_main
from test_wordpiece_tokenizer import _PIECES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
D = 64
PROMPTS = ["There is a left pleural effusion.", "There is no pneumothorax.",
           "No evidence of focal airspace disease."]


def _cfg(m, optional: bool):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),
        text=m.TextConfig(**TEXT, use_text_projection=optional),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0, use_layer_norm=optional),
        loss=m.LossConfig(hidden_dim=D),
    )


def _model_config(optional: bool) -> dict:
    """The YAML model.model_config block of the toy configuration."""
    return {"vision_config": {**VIT}, "text_config": {**TEXT, "use_text_projection": optional},
            "align_transformer_config": {"hidden_size": D, "num_hidden_layers": 2,
                                         "num_attention_heads": 4, "mlp_ratio": 2.0,
                                         "use_layer_norm": optional},
            "loss": {"RadZeroLoss": {"hidden_dim": D}}}


def _hf_models():
    from transformers.models.dinov2.configuration_dinov2 import Dinov2Config
    from transformers.models.dinov2.modeling_dinov2 import Dinov2Encoder, Dinov2Model
    from transformers.models.mpnet.configuration_mpnet import MPNetConfig
    from transformers.models.mpnet.modeling_mpnet import MPNetModel

    vc = Dinov2Config(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2,
                      image_size=42, patch_size=14, layer_norm_eps=1e-6)
    tc = MPNetConfig(vocab_size=211, hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=66)
    torch.manual_seed(0)
    return Dinov2Model(vc).eval(), Dinov2Encoder(vc).eval(), MPNetModel(tc, add_pooling_layer=False)


def _perturbed(sd, rng):
    """Every float tensor moved off its init, so no identity hides a layout."""
    return {k: (v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            if v.is_floating_point() else v.numpy() for k, v in sd.items()}


def _write_snapshot(path, optional: bool, rng) -> dict:
    """A RadZero hub snapshot: model.safetensors (HF names), vocab.txt,
    preprocessor_config.json. -> its state dict."""
    from safetensors.numpy import save_file

    vision, align, text = _hf_models()
    sd = {}
    for prefix, m in (("vision_model.", vision), ("align_transformer.transformer_layers.", align),
                      ("text_model.", text)):
        sd.update({prefix + k: v for k, v in _perturbed(m.state_dict(), rng).items()})
    sd["loss_fns.RadZeroLoss.loss_temperature"] = np.array([np.log(0.07)], np.float32)
    sd["loss_fns.RadZeroLoss.layer_norm.weight"] = (1 + 0.1 * rng.standard_normal(D)).astype(
        np.float32)
    sd["loss_fns.RadZeroLoss.layer_norm.bias"] = (0.1 * rng.standard_normal(D)).astype(np.float32)
    if optional:
        for name, shape in (("align_transformer.layer_norm.weight", (D,)),
                            ("align_transformer.layer_norm.bias", (D,)),
                            ("text_projector.weight", (2 * D, D)), ("text_projector.bias", (2 * D,)),
                            ("loss_fns.OpenSigLipLoss.logit_bias", (1,))):
            sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        sd["align_transformer.layer_norm.weight"] += 1
        sd["loss_fns.RadZeroLoss.attn_temperature"] = np.array([np.log(0.05)], np.float32)
        sd["loss_fns.OpenClipLoss.logit_scale"] = np.array([np.log(1 / 0.07)], np.float32)
        sd["loss_fns.OpenSigLipLoss.logit_scale"] = np.array([np.log(10.0)], np.float32)
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    vocab = _PIECES + [f"[unused{i}]" for i in range(211 - len(_PIECES))]
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"image_mean": [0.5, 0.45, 0.4], "image_std": [0.25, 0.26, 0.27],
                   "size": {"height": 56, "width": 56}, "resample": 3}, f)
    return sd


_SNAPSHOTS: dict = {}


def _snapshot(tmp_path_factory, optional: bool):
    """(optional keys?, snapshot dir, converted dir, the JAX converter's tree),
    made once a module for each value of ``optional``."""
    pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    if optional not in _SNAPSHOTS:
        from tools.convert_checkpoint import load_state_dict as jax_load_state_dict

        root = tmp_path_factory.mktemp("ckpt")
        snap, conv = str(root / "snapshot"), str(root / "converted")
        _write_snapshot(snap, optional, np.random.default_rng(int(optional)))
        tool.main(["--src", snap, "--dst", conv, "--kind", "radzero"])
        jtree = jconvert.convert_radzero_checkpoint(jax_load_state_dict(snap), 2, 2, 2)
        _SNAPSHOTS[optional] = (optional, snap, conv, jax_fp32(jtree))
    return _SNAPSHOTS[optional]


@pytest.fixture(scope="module", params=[False, True], ids=["required", "optional"])
def snapshot(request, tmp_path_factory):
    return _snapshot(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def plain_snapshot(tmp_path_factory):
    """The snapshot without optional keys: the entry points run on it."""
    return _snapshot(tmp_path_factory, False)


def jax_fp32(tree):
    """The JAX tool's cast of every leaf to fp32 (tools/convert_checkpoint.py)."""
    if isinstance(tree, dict):
        return {k: jax_fp32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32]


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(_DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (), (0, 4)][i]
        x = torch.randn(shape, generator=g) * 100
        out[f"t{i}.{str(dt).split('.')[1]}"] = x.to(dt)
    return out


def test_safetensors_reads_what_safetensors_writes(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    ts = _tensors()
    st.save_file(ts, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = safetensors_io.load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(ts)
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    # the numpy flavour: the same bytes
    sn = pytest.importorskip("safetensors.numpy")
    arrays = {k: v.numpy() for k, v in ts.items() if v.dtype != torch.bfloat16}
    sn.save_file(arrays, str(tmp_path / "b.safetensors"))
    for k, t in safetensors_io.iter_tensors(str(tmp_path / "b.safetensors")):
        np.testing.assert_array_equal(t.numpy(), arrays[k])


def test_safetensors_writes_what_safetensors_reads(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    ts = _tensors(1)
    safetensors_io.save_file(ts, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = st.load_file(str(tmp_path / "a.safetensors"))
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    from safetensors import safe_open

    with safe_open(str(tmp_path / "a.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_load_state_dict_upcasts_half_snapshots_like_safetensors(tmp_path):
    """A bf16 / fp16 snapshot comes out as safetensors gives it, upcast to fp32;
    integers keep their dtype; a .bin goes through torch.load."""
    st = pytest.importorskip("safetensors.torch")
    ts = _tensors(2)
    st.save_file(ts, str(tmp_path / "model.safetensors"))
    sd = tool.load_state_dict(str(tmp_path))
    for k, t in st.load_file(str(tmp_path / "model.safetensors")).items():
        want = (t.float() if t.is_floating_point() else t).numpy()
        assert sd[k].dtype == want.dtype
        np.testing.assert_array_equal(sd[k], want)
    torch.save({"w": torch.randn(3, 2).half()}, str(tmp_path / "extra.bin"))
    w = tool.load_state_dict(str(tmp_path / "extra.bin"))["w"]
    assert w.dtype == np.float32


def test_strip_wrappers_and_layer_counts():
    sd = {"module.text_model.encoder.layer.0.x": 0, "module.text_model.encoder.layer.11.x": 0,
          "module.vision_model.encoder.layer.3.attention": 0}
    sd = tool.strip_wrappers(sd)
    assert "text_model.encoder.layer.11.x" in sd
    assert tool.n_layers(sd, "text_model.encoder.layer.") == 12
    assert tool.n_layers(sd, "vision_model.encoder.layer.") == 4
    assert tool.n_layers(sd, "align_transformer.transformer_layers.layer.") == 0


# ---------------------------------------------------------------------------
# The converter
# ---------------------------------------------------------------------------

def test_converter_matches_jax_converter_bit_for_bit(snapshot):
    """state.pt holds the tree that the JAX converter followed by the bridge
    gives, bit for bit, with each optional key present or absent; vocab.txt
    and processor_config.json come along."""
    optional, snap, conv, jtree = snapshot
    params = torch.load(os.path.join(conv, "state.pt"), weights_only=True)
    _assert_bit_equal(params_to_numpy(params), params_to_numpy(params_from_jax(jtree)))
    present = {"layer_norm" in params["align_transformer"], "text_projector" in params,
               "log_attn_temperature" in params["loss_fns"]["RadZeroLoss"],
               "OpenClipLoss" in params["loss_fns"], "OpenSigLipLoss" in params["loss_fns"]}
    assert present == {optional}
    with open(os.path.join(snap, "vocab.txt"), "rb") as a, \
            open(os.path.join(conv, "vocab.txt"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(conv, "processor_config.json")) as f:
        assert json.load(f) == {"image_mean": [0.5, 0.45, 0.4], "image_std": [0.25, 0.26, 0.27],
                                "size": {"height": 56, "width": 56}, "resample": 3}


def test_to_hf_state_dict_round_trips(snapshot, tmp_path):
    """The port's tree -> HF names -> the port's safetensors writer -> the
    converter gives the tree back unchanged; the names are the snapshot's."""
    optional, snap, conv, _ = snapshot
    params = torch.load(os.path.join(conv, "state.pt"), weights_only=True)
    sd = to_hf_state_dict(params, _cfg(tconf, optional))
    from safetensors.numpy import load_file

    assert sorted(sd) == sorted(load_file(os.path.join(snap, "model.safetensors")))
    safetensors_io.save_file(sd, str(tmp_path / "model.safetensors"))
    back = tool.convert(str(tmp_path), str(tmp_path / "out"))
    _assert_bit_equal(params_to_numpy(back), params_to_numpy(params))


def test_to_hf_state_dict_of_init_radzero_round_trips():
    """The port's own init at the toy shapes survives the trip too."""
    cfg = _cfg(tconf, True)
    params = init_radzero(torch.Generator().manual_seed(3), cfg,
                          loss_apply=("RadZeroLoss", "OpenClipLoss", "OpenSigLipLoss"))
    params["align_transformer"]["layer_norm"]["bias"] += 0.5
    back = tool.convert_state_dict(to_hf_state_dict(params, cfg), "radzero")
    _assert_bit_equal(params_to_numpy(back), params_to_numpy(params))
    with pytest.raises(ValueError, match="no HF names"):
        to_hf_state_dict(params, dataclasses.replace(cfg, align=tconf.AlignConfig(
            model_type="mlp")))


@pytest.mark.parametrize("kind", ["dinov2", "mpnet"])
def test_tower_kinds_match_jax(kind, tmp_path):
    """--kind dinov2 / mpnet on save_pretrained directories against the JAX
    tower converters followed by the bridge."""
    pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    from tools.convert_checkpoint import load_state_dict as jax_load_state_dict

    vision, _, text = _hf_models()
    model = vision if kind == "dinov2" else text
    model.save_pretrained(str(tmp_path / "snap"))
    tool.main(["--src", str(tmp_path / "snap"), "--dst", str(tmp_path / "out"),
               "--kind", kind])
    got = torch.load(str(tmp_path / "out" / "state.pt"), weights_only=True)
    sd = jax_load_state_dict(str(tmp_path / "snap"))
    key = "vision_model" if kind == "dinov2" else "text_model"
    jtree = (jconvert.convert_dinov2(sd, 2) if kind == "dinov2" else jconvert.convert_mpnet(sd, 2))
    want = params_from_jax({key: jax_fp32(jtree)})[key]
    _assert_bit_equal(params_to_numpy(got), params_to_numpy(want))


def test_load_converted_reads_the_grid_off_the_position_table(snapshot):
    """The default config: the flagship's widths at 518 px, with the table's
    grid, the depths and the optional modules of the tree."""
    optional, _, conv, _ = snapshot
    params, cfg = runbook.load_converted(conv)
    assert cfg.vision.pretrain_img_size == 42 and cfg.vision.img_size == 518
    assert (cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers,
            cfg.text.num_hidden_layers) == (2, 2, 2)
    assert cfg.align.use_layer_norm == cfg.text.use_text_projection == optional
    assert cfg.vision.hidden_size == cfg.text.hidden_size == 768
    cfg2 = _cfg(tconf, False)
    assert runbook.load_converted(conv, cfg2)[1] is cfg2
    proc = runbook.build_processor(conv)
    assert (proc.size, tuple(proc.mean), tuple(proc.std)) == (56, (0.5, 0.45, 0.4),
                                                              (0.25, 0.26, 0.27))


def test_checkpoint_tokenizer_resolves(snapshot, tmp_path):
    """--tokenizer when given, else the checkpoint's vocab.txt, else the hash
    tokenizer over the configuration's vocabulary."""
    _, _, conv, _ = snapshot
    assert type(runbook.checkpoint_tokenizer(conv)).__name__ == "WordPieceTokenizer"
    assert type(runbook.checkpoint_tokenizer(str(tmp_path), os.path.join(conv, "vocab.txt"))
                ).__name__ == "WordPieceTokenizer"
    tok = runbook.checkpoint_tokenizer(str(tmp_path), vocab_size=211, max_length=16)
    assert type(tok).__name__ == "WhitespaceHashTokenizer"
    assert (tok.vocab_size, tok.max_length) == (211, 16)


# ---------------------------------------------------------------------------
# compute_logits on converted weights
# ---------------------------------------------------------------------------

def _pixels(seed=1, b=2):
    return np.random.default_rng(seed).standard_normal((b, 56, 56, 3)).astype(np.float32)


@pytest.mark.parametrize("eager", [False, True])
def test_compute_logits_on_converted_weights_matches_jax(snapshot, eager):
    """The port on its converted tree (the K1-K5 twins, or the eager route)
    against the JAX package on the JAX-converted tree (fused towers, or xla),
    with WordPiece ids from the snapshot's vocab: rtol / atol 1e-5 and a map
    MAE below 1e-6 (tests/test_torch_slice.py) of the maps' scale, mean |map|
    where that exceeds 1: these maps reach |6| (attention temperature 0.05),
    and fp32 rounding noise grows with the values."""
    optional, snap, conv, jtree = snapshot
    params, tcfg = runbook.load_converted(conv, _cfg(tconf, optional))
    jcfg = _cfg(jconf, optional)
    jcfg = (jconf.with_fused_towers(jcfg) if not eager else dataclasses.replace(
        jcfg, vision=dataclasses.replace(jcfg.vision, attn_impl="xla"),
        align=dataclasses.replace(jcfg.align, attn_impl="xla")))
    ids, mask = WordPieceTokenizer(conv, max_length=16)(PROMPTS)
    assert (ids != 3).all()  # no [UNK]
    pv = _pixels()
    ref = jax_compute_logits(jtree, jcfg, jnp.asarray(pv), jnp.asarray(ids), jnp.asarray(mask))
    out = compute_logits(params, tcfg, torch.from_numpy(pv), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask).long(), eager=eager)
    for k in ("logits", "similarity_scores"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)
    maps = np.asarray(ref["similarity_scores"])
    mae = np.abs(out["similarity_scores"].numpy() - maps).mean()
    assert mae < 1e-6 * max(1.0, np.abs(maps).mean()), (mae, np.abs(maps).mean())


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _png(path, seed=4, hw=(70, 60)):
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, hw, dtype=np.uint8),
                    "L").save(path)
    return str(path)


def test_runbook_main_runs_inference_and_the_suite(plain_snapshot, tmp_path):
    """The runbook on a converted checkpoint (--converted, --config) on the CPU:
    model_inference's probabilities against the JAX package's model_inference
    on the JAX-converted tree at 1e-5, and a result.json for the suite."""
    _, _, conv, jtree = plain_snapshot
    from radzero_torch.tools.synthetic_eval_data import build_all

    cfg_json = tmp_path / "model_config.json"
    cfg_json.write_text(json.dumps(_model_config(False)))
    root = build_all(str(tmp_path / "data"), n=4)
    img = _png(tmp_path / "cxr.png")
    out = tmp_path / "out"
    runbook.main(["--converted", conv, "--config", str(cfg_json), "--image", img,
                  "--text", *PROMPTS, "--device", "cpu", "--batch_size", "4",
                  "--data_root", root, "--tasks", "Chexpert", "MS-CXR", "SIIM",
                  "--out", str(out)])
    report = json.loads((out / "inference.json").read_text())
    maps = np.load(out / "similarity_map.npy")
    assert report["map_shape"] == [3, 70, 60] == list(maps.shape)

    proc = runbook.build_processor(conv)
    jproc = JaxProcessor(size=proc.size, mean=proc.mean, std=proc.std)
    probs, _ = jax_model_inference(img, PROMPTS, JaxWordPiece(conv), jproc,
                                   (jtree, _cfg(jconf, False)))
    np.testing.assert_allclose(report["similarity_prob"], probs, rtol=1e-5, atol=1e-5)

    result = json.loads((out / "result.json").read_text())
    assert set(result) == {"classification", "grounding", "segmentation"}
    assert result["classification"] and result["grounding"] and result["segmentation"]


def test_server_main_serves_a_converted_checkpoint(plain_snapshot, tmp_path):
    """python -m radzero_torch.eval.server --ckpt DIR in a fresh process: the
    tokenizer is the checkpoint's vocab.txt, the image statistics its
    processor_config.json, and a JPEG's answer is bit-equal to an engine's
    in this process on load_converted's tree."""
    _, _, conv, _ = plain_snapshot
    cfg_json = tmp_path / "model_config.json"
    cfg_json.write_text(json.dumps(_model_config(False)))
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps({"p": PROMPTS}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    cmd, kw = _server_main("--ckpt", conv, "--config", str(cfg_json), "--prompts_json",
                           str(prompts), "--host", "127.0.0.1", "--port", str(port))
    with open(tmp_path / "server.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, **kw)
    jpeg = _jpeg(np.random.default_rng(5))
    try:
        deadline = time.monotonic() + 300
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()[-3000:]
            try:
                health = _get(f"{base}/healthz")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "the server never answered /healthz"
                time.sleep(0.5)
        assert health == {"status": "ok", "prompt_sets": ["p"]}
        out = _post(f"{base}/predict?prompt_set=p&maps=patch", jpeg, "image/jpeg")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    params, cfg = runbook.load_converted(conv, _cfg(tconf, False))
    spec = ImageSpec(size=56, mean=(0.5, 0.45, 0.4), std=(0.25, 0.26, 0.27))
    with ServingEngine(params, cfg, WordPieceTokenizer(conv), device="cpu", max_batch=32,
                       dtype=torch.bfloat16, channels=1, image_spec=spec,
                       preprocess_threads=2) as engine:
        engine.register_prompt_set("p", PROMPTS)
        _same(out, engine.submit(jpeg, "p", want_maps="patch").result(timeout=120))
    assert out["similarity_maps"] is not None and np.asarray(out["similarity_maps"]).shape == \
        (3, 4, 4)

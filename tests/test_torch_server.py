"""The port's HTTP front-end (radzero_torch.eval.server) over its engine, on
the CPU: the mirror of tests/test_http_server.py (predict + health,
concurrent load), the HTTP answers held to the engine's own Futures, and
JPEG bytes through the port's native decoder held to the JAX engine's
``host_backend="native"`` probabilities within the serving tolerance of
tests/test_torch_slice.py (rtol 1e-5, atol 1e-6), and ``python -m
radzero_torch.eval.server --bundle`` started in a fresh process.

Sizes as tests/test_torch_slice.py: D = 64, 2 tower + 2 align + 2 text
layers, 4 heads, 56 px.
"""

import concurrent.futures as cf
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_torch.data import native
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.export import export_zero_shot
from radzero_torch.eval.server import EngineServer
from radzero_torch.eval.serving import ServingEngine
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax

from test_torch_modules import TEXT, VIT, perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64
RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_slice.py's serving tolerance


def _cfg(m):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),
        text=m.TextConfig(**TEXT, fuse_post=False),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


JCFG, TCFG = _cfg(jconf), _cfg(tconf)
SETS = {"cls": ["There is Edema", "There is Mass"],
        "b": ["There is Pneumothorax", "No Finding", "There is Cardiomegaly"]}


@pytest.fixture(scope="module")
def weights():
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), JCFG), np.random.default_rng(0))
    return tree, params_from_jax(tree)


def _tok():
    return WhitespaceHashTokenizer(vocab_size=211, max_length=12)


def _engine(params, **kw):
    kw = {"max_batch": 4, "max_delay_ms": 20, "channels": 1, **kw}
    return ServingEngine(params, TCFG, _tok(), device="cpu", dtype=torch.float32,
                         preprocess_threads=2, **kw)


def _jpeg(rng, hw=(40, 30)):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, hw, dtype=np.uint8), "L").save(buf, "JPEG", quality=95)
    return buf.getvalue()


def _post(url, data, ctype):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _same(http, fut):
    """An HTTP answer and a Future's result carry the same numbers: JSON
    writes a float's shortest repr, which reads back to the same float."""
    assert np.array_equal(np.asarray(http["probs"], np.float32), fut["probs"])
    if fut["similarity_maps"] is None:
        assert http["similarity_maps"] is None
    else:
        assert np.array_equal(np.asarray(http["similarity_maps"], np.float32),
                              fut["similarity_maps"])


def test_http_predict_and_health(weights):
    _, params = weights
    rng = np.random.default_rng(0)
    jpeg = _jpeg(rng)
    with _engine(params) as engine, EngineServer(engine, SETS) as server:
        port = server.start(host="127.0.0.1")
        base = f"http://127.0.0.1:{port}"
        assert _get(f"{base}/healthz") == {"status": "ok", "prompt_sets": ["b", "cls"]}
        assert _get(f"{base}/prompt_sets") == SETS

        # one request at a time: each rides a batch of 1, as the Future's does
        for maps, shape in (("patch", (2, 4, 4)), ("full", (2, 40, 30)), ("none", None)):
            out = _post(f"{base}/predict?prompt_set=cls&maps={maps}", jpeg, "image/jpeg")
            assert out["prompts"] == SETS["cls"]
            assert all(0.0 < p < 1.0 for p in out["probs"])
            if shape is not None:
                assert np.asarray(out["similarity_maps"]).shape == shape
            _same(out, engine.submit(jpeg, "cls", want_maps=maps).result(timeout=120))

        # decoded-array JSON body, no maps
        img = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
        out2 = _post(f"{base}/predict?prompt_set=b",
                     json.dumps({"image": img.tolist()}).encode(), "application/json")
        assert out2["similarity_maps"] is None and len(out2["probs"]) == 3
        _same(out2, engine.submit(img, "b").result(timeout=120))

        # error paths
        for path, code in (("/predict?prompt_set=nope", 400),
                           ("/predict?prompt_set=cls&maps=all", 400), ("/other", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{base}{path}", jpeg, "image/jpeg")
            assert err.value.code == code
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/predict?prompt_set=cls", b"not a jpeg", "image/jpeg")
        assert err.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/nothing")
        assert err.value.code == 404


def test_http_server_under_concurrent_load(weights):
    """Many concurrent clients across two prompt sets: every request
    succeeds with the right shapes, answers for the same payload agree
    across batches, and each is the engine's own answer for those bytes."""
    _, params = weights
    rng = np.random.default_rng(1)
    jpegs = [_jpeg(rng) for _ in range(4)]
    with _engine(params, max_delay_ms=5) as engine, EngineServer(engine, SETS) as server:
        base = f"http://127.0.0.1:{server.start(host='127.0.0.1')}"

        def one(i):
            ps = "cls" if i % 2 == 0 else "b"
            img_i = (i // 2) % 4
            return ps, img_i, _post(f"{base}/predict?prompt_set={ps}&maps=patch", jpegs[img_i],
                                    "image/jpeg")

        with cf.ThreadPoolExecutor(max_workers=16) as pool:
            results = [f.result() for f in [pool.submit(one, i) for i in range(48)]]
        direct = {(ps, i): engine.submit(jpegs[i], ps, want_maps="patch").result(timeout=120)
                  for ps in SETS for i in range(4)}
    assert sum(engine.batch_sizes) == 48 + 8
    for ps, img_i, out in results:
        assert len(out["probs"]) == len(SETS[ps])
        assert all(0.0 <= p <= 1.0 for p in out["probs"])
        ref = direct[(ps, img_i)]
        # batches of other sizes run other CPU matmul blockings
        np.testing.assert_allclose(out["probs"], ref["probs"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["similarity_maps"], ref["similarity_maps"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
@pytest.mark.parametrize("fast_scale", [False, True])
def test_native_jpeg_http_matches_jax_engine(weights, fast_scale):
    """JPEG bytes through the port's native decoder (over HTTP) against the
    JAX engine's host_backend="native" on the same bytes and weights."""
    from radzero_tpu.data.processing import BlipStyleImageProcessor
    from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTokenizer
    from radzero_tpu.eval.serving import ServingEngine as JaxServingEngine

    tree, params = weights
    rng = np.random.default_rng(2)
    jpegs = [_jpeg(rng, (240, 200)), _jpeg(rng, (40, 30))]
    answers = []
    with _engine(params, host_backend="native", fast_scale=fast_scale) as engine, \
            EngineServer(engine, {"cls": SETS["cls"]}) as server:
        assert engine.host_backend == "native"
        base = f"http://127.0.0.1:{server.start(host='127.0.0.1')}"
        for data in jpegs:
            answers.append(_post(f"{base}/predict?prompt_set=cls&maps=full", data, "image/jpeg"))
            _same(answers[-1], engine.submit(data, "cls", want_maps="full").result(timeout=120))
    jax_engine = JaxServingEngine(
        jax.tree.map(jnp.asarray, tree), JCFG, BlipStyleImageProcessor(size=56),
        JaxTokenizer(vocab_size=211, max_length=12), max_batch=4, max_delay_ms=20,
        dtype=jnp.float32, host_backend="native", channels=1, fused_tower=False,
        fast_scale=fast_scale)
    with jax_engine:
        jax_engine.register_prompt_set("cls", SETS["cls"])
        refs = [jax_engine.submit(d, "cls", want_maps="full").result(timeout=300) for d in jpegs]
    for out, ref, hw in zip(answers, refs, ((240, 200), (40, 30))):
        np.testing.assert_allclose(out["probs"], ref["probs"], rtol=RTOL, atol=ATOL)
        maps = np.asarray(out["similarity_maps"])
        assert maps.shape == (2, *hw)
        np.testing.assert_allclose(maps, ref["similarity_maps"], rtol=RTOL, atol=ATOL)


def test_native_backend_raises_without_the_library(weights, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native preprocessing library unavailable"):
        _engine(weights[1], host_backend="native")
    with _engine(weights[1], host_backend="auto") as engine:
        assert engine.host_backend == "pil"
    with pytest.raises(ValueError, match="host_backend"):
        _engine(weights[1], host_backend="opencv")


@pytest.fixture(scope="module")
def bundle(weights, tmp_path_factory):
    """A uint8 grayscale bundle at batch 2 x the 3 prompts of SETS["b"]."""
    return export_zero_shot(weights[1], TCFG, str(tmp_path_factory.mktemp("bundle")),
                            batch_size=2, n_prompts=3, max_tokens=12, dtype=torch.float32,
                            from_uint8=True, channels=1, device="cpu")


def _server_main(*args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return [sys.executable, "-m", "radzero_torch.eval.server", "--device", "cpu", *args], \
        dict(cwd=REPO, env=env, **kw)


def test_main_serves_a_bundle(bundle, tmp_path):
    """The server's command line over a bundle, in a fresh process: /healthz
    and /prompt_sets answer, and a JPEG's answer is the one an engine in this
    process gives from the same bundle."""
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps({"b": SETS["b"]}))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    cmd, kw = _server_main("--bundle", bundle, "--prompts_json", str(prompts),
                           "--host", "127.0.0.1", "--port", str(port))
    with open(tmp_path / "server.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, **kw)
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
        assert health == {"status": "ok", "prompt_sets": ["b"]}
        assert _get(f"{base}/prompt_sets") == {"b": SETS["b"]}
        jpeg = _jpeg(np.random.default_rng(3))
        out = _post(f"{base}/predict?prompt_set=b&maps=patch", jpeg, "image/jpeg")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    with ServingEngine.from_bundle(bundle, _tok(), preprocess_threads=2) as engine:
        engine.register_prompt_set("b", SETS["b"])
        _same(out, engine.submit(jpeg, "b", want_maps="patch").result(timeout=120))


@pytest.mark.parametrize("flag, says", [("--bundle", "exported for sets of 3 prompts"),
                                         ("--ckpt", "holds no state.pt")])
def test_main_refuses(bundle, flag, says):
    """--bundle without a prompts file (the one-prompt default set cannot fill
    a bundle's n_prompts) and --ckpt on a directory that holds no converted
    checkpoint (here the bundle's) stop at the command line. A converted
    checkpoint is served in tests/test_torch_checkpoint.py."""
    cmd, kw = _server_main(flag, bundle, "--port", "0")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kw)
    assert proc.returncode == 2 and says in proc.stderr, proc.stderr[-3000:]

"""Plain twins of K1-K5 against the JAX kernels, fp32 on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as the JAX suite
does on CPU); the port side runs the wrappers on CPU tensors, which take
the plain twins. Inputs come from numpy with fixed seeds. Tolerances are
the JAX suite's: 2e-5 for the fused layer kernels
(tests/test_fused_layer.py), rtol 1e-4 / atol 1e-5 on VL-CABS logits and
1e-4 on the maps (tests/test_pallas_vlcabs.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops import fused_layer as jfl
from radzero_tpu.ops import pallas_vlcabs as jvl
from radzero_torch.ops import _build
from radzero_torch.ops import fused_layer as tfl
from radzero_torch.ops import vlcabs_fused as tvl


def _rand(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


# rows: a multiple of the JAX row block, and ragged ones the JAX side pads
@pytest.mark.parametrize("n", [512, 74, 3])
def test_fused_preattn_twin_matches_jax(n):
    rng = np.random.default_rng(n)
    d = 64
    arrays = (_rand(rng, n, d), _rand(rng, d, std=0.1, mean=1.0), _rand(rng, d, std=0.1),
              _rand(rng, d, 3 * d, std=0.1), _rand(rng, 3 * d, std=0.1))
    (jx, *jp), (tx, *tp) = _both(*arrays)
    ref = jfl.fused_preattn(jx, *jp, eps=1e-6)
    launches = tfl.fused_preattn.launches
    out = tfl.fused_preattn(tx, *tp, eps=1e-6)
    assert tfl.fused_preattn.launches == launches  # CPU tensor: plain twin, no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("l", [128, 17, 130])
def test_flash_attention_packed_twin_matches_jax(l):
    """The port runs the real length; the JAX kernel runs the sequence
    lane-padded to a multiple of 128 with ``kv_len`` masking the tail."""
    rng = np.random.default_rng(l)
    b, h, d = 2, 4, 64
    qkv = _rand(rng, b, l, 3 * d)
    l_pad = (l + 127) // 128 * 128
    jqkv = jnp.pad(jnp.asarray(qkv), ((0, 0), (0, l_pad - l), (0, 0)))
    ref = jfl.flash_attention_packed(jqkv, h, kv_len=l if l_pad != l else None)[:, :l]
    out = tfl.flash_attention_packed(torch.from_numpy(qkv), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [256, 74])
def test_fused_postattn_twin_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    d, f = 64, 128
    arrays = (
        _rand(rng, n, d), _rand(rng, n, d), _rand(rng, d, d, std=0.1), _rand(rng, d, std=0.1),
        _rand(rng, d, std=0.1, mean=0.7), _rand(rng, d, std=0.1, mean=1.0),
        _rand(rng, d, std=0.1), _rand(rng, d, f, std=0.1), _rand(rng, f, std=0.1),
        _rand(rng, f, d, std=0.1), _rand(rng, d, std=0.1), _rand(rng, d, std=0.1, mean=1.3),
    )
    jp, tp = _both(*arrays)
    ref = jfl.fused_postattn(*jp, eps=1e-6)
    out = tfl.fused_postattn(*tp, eps=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# rows: not a multiple of the JAX row block (256) nor of any CUDA tile
@pytest.mark.parametrize("n", [256, 74, 3])
def test_fused_mpnet_post_twin_matches_jax(n):
    """K4: the forward of the JAX fused_mpnet_post_vjp (interpreted on the
    CPU) against fused_mpnet_post, 2e-5 as tests/test_fused_layer.py; the
    JAX kernel's rational erf is <= 1.5e-7 from the exact erf used here."""
    rng = np.random.default_rng(200 + n)
    d, f = 64, 128
    arrays = (
        _rand(rng, n, d), _rand(rng, n, d), _rand(rng, d, d, std=0.1), _rand(rng, d, std=0.1),
        _rand(rng, d, std=0.1, mean=1.0), _rand(rng, d, std=0.1), _rand(rng, d, f, std=0.1),
        _rand(rng, f, std=0.1), _rand(rng, f, d, std=0.1), _rand(rng, d, std=0.1),
        _rand(rng, d, std=0.1, mean=1.3), _rand(rng, d, std=0.1),
    )
    jp, tp = _both(*arrays)
    ref = jfl.fused_mpnet_post_vjp(*jp, 1e-12)
    launches = tfl.fused_mpnet_post.launches
    out = tfl.fused_mpnet_post(*tp, eps=1e-12)
    assert tfl.fused_mpnet_post.launches == launches  # CPU tensor: plain twin, no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,l", [(5, 37), (3, 130), (16, 128)])
def test_vlcabs_fused_twin_matches_jax(n, l):
    rng = np.random.default_rng(1000 + l)
    q = _rand(rng, n, 64)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = _rand(rng, 3, l, 64)
    tau = np.float32(0.07)
    ref_logits, ref_scores = jvl.vlcabs_fused(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tau))
    logits, scores = tvl.vlcabs_fused(torch.from_numpy(q), torch.from_numpy(t),
                                      torch.tensor(tau))
    assert logits.shape == (n, 3) and scores.shape == (3, n, l)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=1e-4, atol=1e-4)


def test_vlcabs_twin_survives_tiny_temperature():
    """exp(s - rowmax) keeps the aggregate finite where exp(s) overflows."""
    rng = np.random.default_rng(7)
    q = _rand(rng, 4, 32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = _rand(rng, 2, 50, 32)
    logits, _ = tvl.vlcabs_fused(torch.from_numpy(q), torch.from_numpy(t),
                                 torch.tensor(1e-3))
    assert torch.isfinite(logits).all()


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        tfl.fused_preattn(x, x[0], x[0], x.new_empty((64, 192)), x.new_empty(192))
    with pytest.raises(ValueError, match="device"):
        tvl.vlcabs_fused(x, x.new_empty((2, 5, 64)), torch.tensor(0.07))
    with pytest.raises(ValueError, match="device"):
        tfl.fused_mpnet_post(x, x, *[x[0]] * 10)
    for fn in (tvl.vlcabs_train_forward, tvl.vlcabs_train_bwd_dq, tvl.vlcabs_train_bwd_dtn):
        with pytest.raises(ValueError, match="device"):
            fn(x, x.new_empty((2, 5, 64)), torch.tensor(0.07), *([x] if "bwd" in fn.__name__ else []))


def test_build_raises_without_nvcc(monkeypatch):
    """No nvcc: a clear error, never the plain twins in the kernels' place."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_find_nvcc_searches_path_and_cuda_home(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    found = _build.find_nvcc()
    assert found is None or found == "/usr/local/cuda/bin/nvcc"
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    assert _build.find_nvcc() == str(tmp_path / "bin" / "nvcc")

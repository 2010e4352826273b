"""The port's alternate encoders against the JAX package's on the CPU: the
registries, the CLIP / SigLIP vision tower (HF layout and timm layout), BERT,
the MAE ViT, the CLIP text tower, the wordpiece aggregation, the resize
matrices, and the HF / timm oracles of tests/test_alt_encoders.py and
tests/test_timm_vit.py where transformers is installed.

Inputs and weights come from numpy seeds (JAX inits with their LN and bias
leaves moved off their init values); the JAX functions run on XLA:CPU.
Tolerances are those of the JAX suite each test mirrors: CLIP, SigLIP and
BERT rtol 1e-4 / atol 3e-5 (tests/test_alt_encoders.py), the timm
converter 1e-4 / 2e-5 (tests/test_timm_vit.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models import bert as jbert
from radzero_tpu.models import clip_text as jclip_text
from radzero_tpu.models import clip_vit as jclip
from radzero_tpu.models import mae_vit as jmae
from radzero_tpu.models import encoders as jenc
from radzero_tpu.ops import resize as jresize
from radzero_tpu.utils import registry as jreg
from radzero_torch.models import bert, clip_text, clip_vit, encoders, mae_vit
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.ops import resize
from radzero_torch.utils import registry

from test_torch_modules import perturbed

TOL = dict(rtol=1e-4, atol=3e-5)


def _port(tree):
    """A tower's JAX tree -> the port's, through the bridge."""
    return params_from_jax({"vision_model": tree})["vision_model"]


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _same_tree(a, b):
    """Two converter outputs (nested dicts of numpy arrays): equal keys, bits."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _pixels(seed, b, size):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def test_registries_have_the_jax_keys():
    """Every key the JAX registries hold (the configs' model_type values),
    and each builds an (init, apply) pair."""
    assert sorted(registry.VISION_ENCODERS.keys()) == sorted(jreg.VISION_ENCODERS.keys())
    assert sorted(registry.TEXT_ENCODERS.keys()) == sorted(jreg.TEXT_ENCODERS.keys())
    assert {"sam", "biomedclip", "xrayclip", "m3ae", "siglip_vision_model"} <= set(
        registry.VISION_ENCODERS.keys())
    for key in registry.VISION_ENCODERS:
        init, apply = encoders.build_vision_encoder(key)
        assert callable(init) and callable(apply)
        assert jenc.build_vision_encoder(key)[1].__name__ == apply.__name__
    for key in registry.TEXT_ENCODERS:
        init, apply = encoders.build_text_encoder(key)
        assert jenc.build_text_encoder(key)[1].__name__ == apply.__name__
    with pytest.raises(KeyError):
        encoders.build_vision_encoder("convnext")


def _hf_clip(seed=0):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf_cfg = CLIPVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, patch_size=16, image_size=64,
        hidden_act="quick_gelu", attention_dropout=0.0,
    )
    torch.manual_seed(seed)
    model = CLIPVisionModel(hf_cfg).eval()
    return model, {k: v.detach().numpy() for k, v in model.state_dict().items()}


CLIP64 = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, patch_size=16, pretrain_img_size=64, img_size=64)


def test_clip_vision_converter_and_forward_match_jax_and_hf():
    pytest.importorskip("transformers")
    model, sd = _hf_clip()
    tree = clip_vit.convert_clip_vision(sd, 2)
    _same_tree(tree, jclip.convert_clip_vision(sd, 2))
    x = _pixels(0, 2, 64)
    out = clip_vit.clip_vit_forward(_port(tree), clip_vit.ClipViTConfig(**CLIP64),
                                    torch.from_numpy(x))
    _close(out, jclip.clip_vit_forward(tree, jclip.ClipViTConfig(**CLIP64), jnp.asarray(x)))
    with torch.no_grad():
        ref = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state.numpy()
    _close(out, ref)


@pytest.mark.parametrize("kind", ["clip", "siglip"])
def test_clip_vision_highres_matches_jax(kind):
    """Stored grid 4 x 4, run at 6 x 6: the bicubic resample with a CLS slot
    (CLIP, quick_gelu) and without one (SigLIP: gelu tanh, final LN)."""
    kw = dict(CLIP64, img_size=96, num_hidden_layers=1)
    if kind == "siglip":
        kw.update(model_type="siglip", hidden_act="gelu_pytorch_tanh", use_class_token=False,
                  final_layernorm=True)
    jcfg, tcfg = jclip.ClipViTConfig(**kw), clip_vit.ClipViTConfig(**kw)
    tree = perturbed(jclip.init_clip_vit(jax.random.PRNGKey(1), jcfg), np.random.default_rng(1))
    x = _pixels(1, 1, 96)
    out = clip_vit.clip_vit_forward(_port(tree), tcfg, torch.from_numpy(x))
    assert out.shape == (1, (kind == "clip") + 36, 64)
    _close(out, jclip.clip_vit_forward(tree, jcfg, jnp.asarray(x)))
    # the serving resample once, then the forward's pass-through: the same bits
    at_grid = clip_vit.clip_params_at_grid(_port(tree), tcfg, 6)
    assert torch.equal(clip_vit.clip_vit_forward(at_grid, tcfg, torch.from_numpy(x)), out)


def test_timm_vit_converter_matches_jax_and_oracle():
    """The BiomedCLIP tower's timm layout (patch bias, no pre-LN, fused qkv,
    trailing norm) against the JAX converter and tests/test_timm_vit.py's
    torch oracle, at that file's 1e-4 / 2e-5."""
    import test_timm_vit as tt

    rng = np.random.default_rng(0)
    sd_t = tt._random_timm_state(rng)
    sd = {k: v.numpy() for k, v in sd_t.items()}
    tree = clip_vit.convert_timm_vit(sd, tt.LAYERS)
    _same_tree(tree, jclip.convert_timm_vit(sd, tt.LAYERS))
    kw = dict(hidden_size=tt.D, num_hidden_layers=tt.LAYERS, num_attention_heads=tt.HEADS,
              intermediate_size=2 * tt.D, patch_size=tt.P, pretrain_img_size=tt.IMG,
              img_size=tt.IMG, hidden_act="gelu_exact", final_layernorm=True)
    x = rng.standard_normal((2, tt.IMG, tt.IMG, 3)).astype(np.float32)
    out = clip_vit.clip_vit_forward(_port(tree), clip_vit.ClipViTConfig(**kw),
                                    torch.from_numpy(x))
    tol = dict(rtol=1e-4, atol=2e-5)
    _close(out, jclip.clip_vit_forward(tree, jclip.ClipViTConfig(**kw), jnp.asarray(x)), **tol)
    _close(out, tt._torch_timm_forward(sd_t, torch.from_numpy(x.transpose(0, 3, 1, 2))), **tol)


BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            vocab_size=211, max_position_embeddings=40)


def _ids(seed, s=3, l=17):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 211, (s, l)).astype(np.int64)
    mask = np.ones((s, l), np.int64)
    mask[1, 10:] = 0
    return ids, mask


def test_bert_converter_and_forward_match_jax_and_hf():
    pytest.importorskip("transformers")
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel

    hf_cfg = HFBertConfig(**BERT, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                          hidden_act="gelu", attn_implementation="eager")
    torch.manual_seed(1)
    model = BertModel(hf_cfg, add_pooling_layer=False).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = bert.convert_bert(sd, 2)
    _same_tree(tree, jbert.convert_bert(sd, 2))
    ids, mask = _ids(2)
    params = params_from_jax({"text_model": tree})["text_model"]
    out = bert.bert_forward(params, bert.BertConfig(**BERT), torch.from_numpy(ids),
                            torch.from_numpy(mask))
    _close(out, jbert.bert_forward(tree, jbert.BertConfig(**BERT), ids, mask))
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    _close(out, ref)


@pytest.mark.parametrize("use_cls_token", [False, True])
def test_bert_hidden_states_and_sentence_features_match_jax(use_cls_token):
    jcfg, tcfg = jbert.BertConfig(**BERT), bert.BertConfig(**BERT)
    tree = perturbed(jbert.init_bert(jax.random.PRNGKey(3), jcfg), np.random.default_rng(3))
    params = params_from_jax({"text_model": tree})["text_model"]
    ids, mask = _ids(4)
    types = np.random.default_rng(5).integers(0, 2, ids.shape)
    last, hidden = bert.bert_forward(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                                     torch.from_numpy(types), output_hidden_states=True)
    ref_last, ref_hidden = jbert.bert_forward(tree, jcfg, ids, mask, types,
                                              output_hidden_states=True)
    assert hidden.shape == (3, 3, 17, 64)
    _close(last, ref_last)
    _close(hidden, ref_hidden)
    feats = bert.bert_sentence_features(params, tcfg, torch.from_numpy(ids),
                                        torch.from_numpy(mask), use_cls_token=use_cls_token)
    _close(feats, jbert.bert_sentence_features(tree, jcfg, ids, mask,
                                               use_cls_token=use_cls_token))


def test_aggregate_tokens_matches_jax():
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 2, 7, 4)).astype(np.float32)
    tokens = [["[CLS]", "pneu", "##monia", "present", "[SEP]", "[PAD]", "[PAD]"],
              ["[CLS]", "no", "eff", "##usi", "##on", "[SEP]"]]
    out, words = bert.aggregate_tokens(emb, tokens)
    ref, ref_words = jbert.aggregate_tokens(emb, tokens)
    assert words == ref_words == [["pneumonia", "present"], ["no", "effusion"]]
    np.testing.assert_array_equal(out, ref)


def test_mae_vision_tokens_match_jax():
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, patch_size=16)
    jcfg, tcfg = jmae.MAEViTConfig(**kw), mae_vit.MAEViTConfig(**kw)
    np.testing.assert_array_equal(mae_vit.sincos_pos_embed_2d(64, 4, 5),
                                  jmae.sincos_pos_embed_2d(64, 4, 5))
    tree = perturbed(jmae.init_mae_vit(jax.random.PRNGKey(4), jcfg), np.random.default_rng(4))
    x = _pixels(4, 2, 64)
    out = mae_vit.mae_vision_tokens(_port(tree), tcfg, torch.from_numpy(x))
    assert out.shape == (2, 1 + 16, 64)
    _close(out, jmae.mae_vision_tokens(tree, jcfg, jnp.asarray(x)))
    assert encoders.vision_params_at_grid(_port(tree), tcfg, 4)["cls_token"] is not None


def test_clip_text_matches_jax_with_pooling_and_causality():
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
              vocab_size=50, max_position_embeddings=16, eos_token_id=49)
    jcfg, tcfg = jclip_text.ClipTextConfig(**kw), clip_text.ClipTextConfig(**kw)
    tree = perturbed(jclip_text.init_clip_text(jax.random.PRNGKey(5), jcfg),
                     np.random.default_rng(5))
    params = params_from_jax({"text_model": tree})["text_model"]
    ids = np.array([[1, 5, 7, 49, 0, 0], [3, 49, 0, 0, 0, 0]], np.int64)
    mask = (np.cumsum(ids == 49, axis=1) - (ids == 49) == 0).astype(np.int64)
    hidden, pooled = clip_text.clip_text_forward(params, tcfg, torch.from_numpy(ids),
                                                 torch.from_numpy(mask))
    ref_hidden, ref_pooled = jclip_text.clip_text_forward(tree, jcfg, ids, mask)
    _close(hidden, ref_hidden)
    _close(pooled, ref_pooled)
    assert torch.equal(pooled[0], hidden[0, 3]) and torch.equal(pooled[1], hidden[1, 1])
    ids2 = ids.copy()
    ids2[0, 2] = 8  # a later token must not move the earlier positions
    hidden2, _ = clip_text.clip_text_forward(params, tcfg, torch.from_numpy(ids2),
                                             torch.from_numpy(mask))
    torch.testing.assert_close(hidden[0, :2], hidden2[0, :2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out,mode", [(27, 27, "bilinear"), (27, 11, "bilinear"),
                                             (7, 13, "bilinear"), (4, 6, "bicubic"),
                                             (64, 32, "bicubic"), (3, 1, "bicubic")])
def test_resizes_match_the_jax_matrices(n_in, n_out, mode):
    """The port's F.interpolate resamples (linear along one axis for SAM's relative
    tables, bicubic over a grid for the position embeddings) against the JAX
    package's interpolation matrices."""
    x = np.random.default_rng(7).standard_normal((2, 5, n_in)).astype(np.float64)
    m = jresize.resize_matrix(n_in, n_out, mode).astype(np.float64)
    if mode == "bilinear":
        out = resize.linear_resize_1d(torch.from_numpy(x), n_out)
        ref = x @ m.T
    else:
        grid = np.random.default_rng(8).standard_normal((3, n_in, n_in))
        out = resize.bicubic_resize_2d(torch.from_numpy(grid), n_out, n_out)
        ref = np.einsum("oh,chw,pw->cop", m, grid, m)
    assert out.dtype == torch.float32
    # torch computes the source coordinate and the taps' weights in fp32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

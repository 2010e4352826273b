"""The serving kernels as ``torch.library`` custom ops, namespace ``radzero``.

``torch.export`` cannot trace into a kernel wrapper: the wrappers hand
``data_ptr()``s to ctypes, and the fake tensors of a trace have no storage.
So each serving kernel is registered here as an op that export keeps whole,
with a fake implementation that gives the output shapes and dtypes:

    radzero::fused_preattn           K1   ops/fused_layer.py fused_preattn
    radzero::flash_attention_packed  K2   ops/fused_layer.py flash_attention_packed
    radzero::fused_postattn          K3   ops/fused_layer.py fused_postattn
    radzero::fused_mpnet_post        K4   ops/fused_layer.py fused_mpnet_post
    radzero::vlcabs_fused            K5   ops/vlcabs_fused.py vlcabs_fused
    radzero::flash_attention         K13  ops/flash_attention.py flash_attention
    radzero::flash_attention_bias    K15  ops/flash_attention.py flash_attention_bias

An op's body calls the wrapper, which launches the kernel for a CUDA tensor
and runs the plain twin for a CPU tensor and counts its launch as it always
does; so an exported program makes the launches, and the counts, of the
eager call. The wrappers route to these ops only while
``torch.compiler.is_exporting()`` is true (:func:`radzero_torch.ops._checks.
exported`): the eager path never enters the dispatcher, whose Python custom
op costs host time on every call. ``calls[name]`` counts the op bodies run,
which eager serving leaves at 0. Forward only: the ops have no autograd
formula, as exported serving programs never differentiate.

A program that holds these ops needs this module imported before
``torch.export.load`` (:func:`radzero_torch.eval.export.load_zero_shot`
does it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

from radzero_torch.ops import flash_attention as fa
from radzero_torch.ops import fused_layer as fl
from radzero_torch.ops import vlcabs_fused as vf

NAMESPACE = "radzero"
# kernel -> its op; chip_smoke.py and the tests read the graph by these names
OPS = {"K1": "fused_preattn", "K2": "flash_attention_packed", "K3": "fused_postattn",
       "K4": "fused_mpnet_post", "K5": "vlcabs_fused", "K13": "flash_attention",
       "K15": "flash_attention_bias"}
calls = {name: 0 for name in OPS.values()}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


@custom_op("radzero::fused_preattn", mutates_args=())
def fused_preattn(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_qkv: Tensor, b_qkv: Tensor,
                  eps: float) -> Tensor:
    calls["fused_preattn"] += 1
    return fl.fused_preattn(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)


@fused_preattn.register_fake
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, eps):
    return x.new_empty((x.shape[0], w_qkv.shape[1]))


@custom_op("radzero::flash_attention_packed", mutates_args=())
def flash_attention_packed(qkv: Tensor, n_heads: int) -> Tensor:
    calls["flash_attention_packed"] += 1
    return fl.flash_attention_packed(qkv, n_heads)


@flash_attention_packed.register_fake
def _(qkv, n_heads):
    b, l, d3 = qkv.shape
    return qkv.new_empty((b, l, d3 // 3))


@custom_op("radzero::fused_postattn", mutates_args=())
def fused_postattn(x: Tensor, attn_out: Tensor, wo: Tensor, bo: Tensor, ls1: Tensor,
                   ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
                   b2: Tensor, ls2: Tensor, eps: float) -> Tensor:
    calls["fused_postattn"] += 1
    return fl.fused_postattn(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2,
                             eps=eps)


@fused_postattn.register_fake
def _(x, *args):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@custom_op("radzero::fused_mpnet_post", mutates_args=())
def fused_mpnet_post(x: Tensor, attn_out: Tensor, wo: Tensor, bo: Tensor, lnsa: Tensor,
                     lnba: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, lnso: Tensor,
                     lnbo: Tensor, eps: float) -> Tensor:
    calls["fused_mpnet_post"] += 1
    return fl.fused_mpnet_post(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo,
                               eps=eps)


@fused_mpnet_post.register_fake
def _(x, *args):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@custom_op("radzero::vlcabs_fused", mutates_args=())
def vlcabs_fused(queries_normed: Tensor, tokens: Tensor, tau: Tensor) -> Tuple[Tensor, Tensor]:
    calls["vlcabs_fused"] += 1
    logits, scores = vf.vlcabs_fused(queries_normed, tokens, tau)
    # the kernels write contiguous outputs, the twins may return other strides
    # (a transposed view here): the program was traced with the fakes' layout
    return logits.contiguous(), scores.contiguous()


@vlcabs_fused.register_fake
def _(queries_normed, tokens, tau):
    n = queries_normed.shape[0]
    b, l, _ = tokens.shape
    return (tokens.new_empty((n, b), dtype=torch.float32),
            tokens.new_empty((b, n, l), dtype=torch.float32))


@custom_op("radzero::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: Optional[float],
                    kv_len: Optional[int]) -> Tensor:
    calls["flash_attention"] += 1
    return fa.flash_attention(q, k, v, scale, kv_len=kv_len).contiguous()


@flash_attention.register_fake
def _(q, k, v, scale, kv_len):
    return q.new_empty(q.shape)


@custom_op("radzero::flash_attention_bias", mutates_args=())
def flash_attention_bias(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, neg_mask: Tensor,
                         scale: Optional[float], kv_len: Optional[int]) -> Tensor:
    calls["flash_attention_bias"] += 1
    return fa.flash_attention_bias(q, k, v, bias, neg_mask, scale, kv_len=kv_len).contiguous()


@flash_attention_bias.register_fake
def _(q, k, v, bias, neg_mask, scale, kv_len):
    return q.new_empty(q.shape)

"""The reference's LM consistency properties (``test_lm_consistency.py``),
run on the port alone on the CPU, and the serving CLI.

prefill + decode equals the teacher-forced forward (dense and MoE; MoE at
its REDUCED capacity factor 4.0, which routes without drops); chunked
attention equals full attention; stateful decode of the recurrent families
equals their forward. bf16 at the reference's own tolerances (rtol 0.08,
atol 0.05; recurrent families max 0.2 and mean 0.03), f32 at rtol 1e-4 with
atol 1e-4 x max(1, max|logit|).
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import attention, build, encdec  # noqa: E402

from _torch_lm import BF16, F32, close, close_bf16, f32, port_params  # noqa: E402

torch.set_num_threads(1)


def _api(arch, dtype):
    return build(dataclasses.replace(configs.get_reduced(arch), dtype=dtype))


def _tokens(vocab, b, s, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, s)))


@pytest.mark.parametrize("shape,chunks,window,hkv", [
    ((2, 256, 4, 16), (32, 64), 0, 2), ((1, 128, 2, 8), (16, 32), 32, 2)],
    ids=["gqa", "windowed"])
def test_chunked_attention_matches_full(shape, chunks, window, hkv):
    b, s, h, hd = shape
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, s, hkv, hd)).astype(
        np.float32)) for _ in range(2))
    full = attention.full_attention(q, k, v, causal=True, window=window)
    chunked = attention.chunked_attention(q, k, v, causal=True,
                                          q_chunk=chunks[0],
                                          k_chunk=chunks[1], window=window)
    torch.testing.assert_close(chunked, full, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", ["qwen3_1p7b", "granite_moe_1b_a400m"])
def test_prefill_decode_matches_forward(arch, dtype):
    api = _api(arch, dtype)
    params = port_params(arch)
    b, s, k0 = 2, 12, 8
    toks = _tokens(api.cfg.vocab, b, s, 7)
    ref, _ = api.forward(params, tokens=toks)
    cmp = close if dtype == F32 else close_bf16
    logits, cache = api.prefill(params, toks[:, :k0], s + 4)
    cmp(logits, ref[:, k0 - 1], what="prefill")
    for t in range(k0, s):
        logits, cache = api.decode_step(params, toks[:, t:t + 1], cache)
        cmp(logits, ref[:, t], what=f"pos {t}")
    assert cache.length.dtype == torch.int32 and int(cache.length) == s


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arch", ["xlstm_125m", "recurrentgemma_9b",
                                  "whisper_base"])
def test_recurrent_decode_matches_forward(arch, dtype):
    api = _api(arch, dtype)
    params = port_params(arch)
    b, s = 2, 10
    toks = _tokens(api.cfg.vocab, b, s, 9)
    kw = {}
    if api.cfg.family == "encdec":
        kw["frames"] = torch.from_numpy(np.random.default_rng(3).normal(
            size=(b, api.cfg.n_audio_frames, api.cfg.d_model)).astype(
                np.float32))
        cache = encdec.init_cache(params, api.cfg, b, s + 2, **kw)
    else:
        cache = api.init_cache(params, b, s + 2)
    ref, _ = api.forward(params, tokens=toks, **kw)
    for t in range(s):
        logits, cache = api.decode_step(params, toks[:, t:t + 1], cache)
        if dtype == F32:
            close(logits, ref[:, t], what=f"pos {t}")
        else:
            err = np.abs(f32(logits) - f32(ref[:, t]))
            assert err.max() < 0.2 and err.mean() < 0.03, (t, err.max())
    assert int(cache.length) == s


def test_moe_capacity_drops_are_bounded():
    """qwen2-moe at its REDUCED capacity factor 1.25: the aux loss stays
    near its 1.0 optimum of uniform routing."""
    api = _api("qwen2_moe_a2p7b", BF16)
    _, aux = api.forward(port_params("qwen2_moe_a2p7b"),
                         tokens=_tokens(api.cfg.vocab, 4, 32, 1))
    assert 0.9 < float(aux) < 4.0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "xlstm-125m", "recurrentgemma-9b",
                                  "whisper-base"])
def test_serve_cli_on_the_cpu(arch, capsys):
    res = serve_lm.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "6", "--gen-len", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 2 x 6 tokens")
    assert out[1].startswith("decoded 4 tokens x 2 requests") \
        and "ms/token" in out[1]
    assert out[2].startswith("sample token ids: [")
    assert res.tokens.shape == (2, 4)
    assert int(res.cache.length) == 6 + 3
    vocab = configs.get_reduced(arch).vocab
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < vocab

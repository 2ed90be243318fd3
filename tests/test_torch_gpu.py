"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card:

    python -m pytest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
without one.  Tolerances: a pool of one id is bit-exact; f32 pools of
F > 1 allow rtol=1e-5, atol=1e-6 (the plain version sums in another
order) on tables of ``init_table``'s scale 0.01; bf16 tables are compared
in f32 within one bf16 ulp (rtol=2**-7, atol=1e-6), since both sides sum
in f32 and round once.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.ref import embedding_bag_ref

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b, f, v, d, dtype, seed=0, odd=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, v, (b, f), generator=gen, device="cuda",
                        dtype=torch.int32)
    if odd:
        ids[:, ::3] = -1
        ids[:, 1::4] = v
        ids[0] = v + 5
    table = (torch.randn((v, d), generator=gen, device="cuda")
             * 0.01).to(dtype)
    return ids, table


@pytest.mark.parametrize("b,f,v,d,dtype,odd", [
    (128, 1, 1_000_000, 64, torch.float32, False),
    (4096, 16, 1_000_000, 64, torch.float32, False),
    (64, 16, 1000, 64, torch.float32, True),
    (256, 16, 50_000, 80, torch.float32, False),
    (256, 8, 10_000, 13, torch.float32, True),
    (4096, 16, 100_000, 64, torch.bfloat16, False),
    (128, 1, 100_000, 64, torch.bfloat16, True),
    (256, 16, 10_000, 20, torch.bfloat16, False),
])
def test_kernel_matches_plain_version(b, f, v, d, dtype, odd):
    _need_card()
    ids, table = _inputs(b, f, v, d, dtype, odd=odd)
    launches = embedding_bag.launches
    out = embedding_bag(ids, table)
    torch.cuda.synchronize()
    assert embedding_bag.launches == launches + 1
    ref = embedding_bag_ref(ids, table)
    assert out.dtype == table.dtype and out.shape == (b, d)
    if f == 1:
        assert torch.equal(out, ref)
    elif dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    if odd:
        assert not out[0].any()                  # a bag of no valid id


def test_pooled_lookup_counts_one_launch_per_call():
    _need_card()
    ids, table = _inputs(8, 1, 4096, 16, torch.float32)
    calls, launches = ops.kernel_calls["pooled_lookup"], embedding_bag.launches
    ops.pooled_lookup(ids, table)
    assert ops.kernel_calls["pooled_lookup"] == calls + 1
    assert embedding_bag.launches == launches + 1


def test_mixed_devices_raise():
    _need_card()
    ids, table = _inputs(4, 2, 100, 8, torch.float32)
    with pytest.raises(ValueError):
        embedding_bag(ids.cpu(), table)


def test_engine_on_the_card_matches_the_cpu_engine():
    _need_card()
    from repro_torch.convert import params_to_numpy, params_from_jax
    from repro_torch.serving import (RecsysScoringEngine, ServingConfig,
                                     StaticSource, init_scoring_params)
    params = init_scoring_params(4096, 16, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    host = params_to_numpy(params)
    cfg = ServingConfig(cache_capacity=128)
    gpu = RecsysScoringEngine(StaticSource(params_from_jax(host)), config=cfg)
    cpu = RecsysScoringEngine(StaticSource(params), config=cfg, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = rng.integers(0, 256, size=(4, 8))
        np.testing.assert_allclose(gpu.score(batch), cpu.score(batch),
                                   rtol=1e-6, atol=1e-7)

"""The port's embedding_bag on the CPU against the JAX package's kernel.

The same ids and table, made with numpy from a seed, go through the JAX
package's Pallas ``embedding_bag`` in interpret mode and through the
port's wrapper on CPU tensors (its plain PyTorch version).

Tolerances: a pool of one id must be bit-exact (the hot-ID cache relies on
it).  For F > 1 the Pallas kernel sums through one-hot matmuls, which
differ from a straight float32 sum by a few ulp (4.8e-7 measured at F=8),
hence rtol=atol=1e-6 in f32.  A bf16 table is summed in f32 and rounded
once, so two sums in different orders differ by at most one bf16 ulp:
rtol=2**-7, which a running sum kept in bf16 exceeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.ref import embedding_bag_ref as jax_embedding_bag_ref
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.ref import embedding_bag_ref

BF16_RTOL = 2.0**-7          # one bf16 ulp of |x|

# (B, F, V, D, dtype, id range): id range "in" draws from [0, V), "odd"
# mixes in negative ids, ids >= V and the padding sentinel V
CASES = {
    "f32-4x8": (4, 8, 4096, 16, "float32", "in"),
    "f32-pool-of-one": (8, 1, 1000, 64, "float32", "in"),
    "f32-wide-d": (16, 4, 700, 200, "float32", "in"),
    "f32-small-v": (4, 8, 300, 16, "float32", "in"),
    "f32-out-of-range": (4, 8, 1000, 16, "float32", "odd"),
    "f32-pool-of-one-sentinel": (16, 1, 1000, 16, "float32", "odd"),
    "bf16": (4, 8, 1000, 32, "bfloat16", "in"),
}


def _inputs(b, f, v, d, dtype, kind, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(b, f)).astype(np.int32)
    if kind == "odd":
        mask = rng.random((b, f))
        ids[mask < 0.2] = -1
        ids[(mask >= 0.2) & (mask < 0.3)] = v           # sentinel
        ids[(mask >= 0.3) & (mask < 0.4)] = v + 7
        ids[0] = -3                                     # a bag of no valid id
    table = rng.standard_normal((v, d)).astype(np.float32)
    if dtype == "bfloat16":
        table = table.astype(jnp.bfloat16)
    return ids, table


def _port(ids, table):
    t = params_from_jax(table, device="cpu")
    return embedding_bag(torch.from_numpy(ids), t).float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_matches_pallas_kernel_in_interpret_mode(case):
    b, f, v, d, dtype, kind = CASES[case]
    ids, table = _inputs(b, f, v, d, dtype, kind)
    want = np.asarray(jax_embedding_bag(jnp.asarray(ids), jnp.asarray(table),
                                        interpret=True)).astype(np.float32)
    got = _port(ids, table)
    assert got.shape == (b, d)
    if f == 1:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if kind == "odd":
        assert not got[0].any()                         # no valid id -> 0


@pytest.mark.parametrize("case", ["f32-4x8", "f32-pool-of-one", "bf16"])
def test_matches_jax_plain_version_on_in_range_ids(case):
    b, f, v, d, dtype, kind = CASES[case]
    ids, table = _inputs(b, f, v, d, dtype, kind, seed=1)
    want = np.asarray(jax_embedding_bag_ref(
        jnp.asarray(ids), jnp.asarray(table))).astype(np.float32)
    got = _port(ids, table)
    if f == 1:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_out_of_range_ids_add_nothing():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, -1, 4, 3], [-4, 5, 4, 4]], dtype=torch.int32)
    out = embedding_bag_ref(ids, table)
    torch.testing.assert_close(out, torch.stack([table[0] + table[3],
                                                 torch.zeros(3)]))


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    ids, table = _inputs(4, 8, 100, 8, "float32", "odd")
    ids_t, table_t = torch.from_numpy(ids), torch.from_numpy(table)
    launches = embedding_bag.launches
    calls = ops.kernel_calls["pooled_lookup"]
    out = ops.pooled_lookup(ids_t, table_t)
    assert torch.equal(out, embedding_bag_ref(ids_t, table_t))
    assert embedding_bag.launches == launches           # no CUDA launch
    assert ops.kernel_calls["pooled_lookup"] == calls + 1


@pytest.mark.parametrize("bad", ["ids-int64", "table-f64", "ids-1d",
                                 "meta-device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ids = torch.zeros((2, 3), dtype=torch.int32)
    table = torch.zeros((5, 4), dtype=torch.float32)
    if bad == "ids-int64":
        ids, err = ids.long(), TypeError
    elif bad == "table-f64":
        table, err = table.double(), TypeError
    elif bad == "ids-1d":
        ids, err = ids.reshape(-1), ValueError
    else:          # neither CPU nor CUDA: no silent fallback
        ids, table, err = ids.to("meta"), table.to("meta"), ValueError
    with pytest.raises(err):
        embedding_bag(ids, table)


def test_bf16_tolerance_rejects_a_bf16_running_sum():
    ids, table = _inputs(64, 16, 1000, 32, "bfloat16", "in", seed=2)
    table_t = params_from_jax(table, device="cpu")
    rows = table_t[torch.from_numpy(ids).long()]             # (B, F, D) bf16
    want = embedding_bag_ref(torch.from_numpy(ids), table_t).float().numpy()
    acc = torch.zeros_like(rows[:, 0])
    for f in range(rows.shape[1]):
        acc = acc + rows[:, f]                 # rounded to bf16 every add
    assert not np.allclose(acc.float().numpy(), want, rtol=BF16_RTOL,
                           atol=1e-6)
    f32_reversed = rows.float().flip(1).sum(1).to(torch.bfloat16)
    np.testing.assert_allclose(f32_reversed.float().numpy(), want,
                               rtol=BF16_RTOL, atol=1e-6)

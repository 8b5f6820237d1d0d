"""The port's GRU sequence module (ocrs_tpu_torch.ops.gru) against the JAX
package's Pallas kernel (interpret mode) and its lax.scan GRU.

Inputs are made with numpy from a seed and handed to both frameworks. On the
CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel itself
is compared with that plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_tpu.models import nn as jnn
from ocrs_tpu.ops.gru_pallas import gru_apply_pallas
from ocrs_tpu.ops.gru_pallas import gru_sequence as jax_gru_sequence
from ocrs_tpu_torch.ops import gru

T, N, H, C = 17, 4, 32, 24

# float32 on both sides, same math, different summation order in the
# [N, H] x [H, 3H] products: a few ulps per step over 17 steps.
F32_ATOL = 1e-5
# bf16 layer: the input projection runs in bf16 and the [N, T, H] result is
# rounded to bf16 (8 bits of mantissa, |h| < 1), so one bf16 ulp near 1 is
# 2**-8 = 3.9e-3; a different rounding of the f32 sum flips at most one ulp.
BF16_ATOL = 2**-8


def _seq_inputs(seed=0):
    rng = np.random.default_rng(seed)
    xr, xz, xn = (rng.standard_normal((T, N, H)).astype(np.float32) for _ in range(3))
    wh = (rng.standard_normal((H, 3 * H)) * np.sqrt(2.0 / H)).astype(np.float32)
    bh = (rng.standard_normal(3 * H) * 0.1).astype(np.float32)
    return xr, xz, xn, wh, bh


def _layer_params(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "wx": (rng.standard_normal((C, 3 * H)) * np.sqrt(2.0 / C)).astype(np.float32),
        "wh": (rng.standard_normal((H, 3 * H)) * np.sqrt(2.0 / H)).astype(np.float32),
        "bx": (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
        "bh": (rng.standard_normal(3 * H) * 0.1).astype(np.float32),
    }


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_sequence_matches_pallas_interpret(reverse):
    args = _seq_inputs()
    want = np.asarray(
        jax_gru_sequence(*(jnp.asarray(a) for a in args), interpret=True, reverse=reverse)
    )
    got = gru.gru_sequence_reference(*(torch.from_numpy(a) for a in args), reverse=reverse)
    assert got.shape == (T, N, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_sequence_matches_scan(reverse):
    # nn.gru_apply over an identity input projection (wx = I, bx = 0) is the
    # bare recurrence over x; its [N, T, 3H] input carries xr, xz, xn.
    xr, xz, xn, wh, bh = _seq_inputs(2)
    x = np.concatenate([xr, xz, xn], axis=-1).transpose(1, 0, 2)  # [N, T, 3H]
    params = {"wx": np.eye(3 * H, dtype=np.float32), "wh": wh, "bx": np.zeros(3 * H, np.float32), "bh": bh}
    want = np.asarray(jnn.gru_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), reverse=reverse))
    got = gru.gru_sequence_reference(*(torch.from_numpy(a) for a in (xr, xz, xn, wh, bh)), reverse=reverse)
    np.testing.assert_allclose(got.numpy().transpose(1, 0, 2), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_apply_matches_jax_f32(reverse):
    params = _layer_params()
    x = np.random.default_rng(3).standard_normal((N, T, C)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    want_pallas = np.asarray(gru_apply_pallas(jp, jnp.asarray(x), reverse=reverse, interpret=True))
    want_scan = np.asarray(jnn.gru_apply(jp, jnp.asarray(x), reverse=reverse))
    got = gru.gru_apply(_torch(params), torch.from_numpy(x), reverse=reverse)
    assert got.shape == (N, T, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_scan, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_apply_matches_pallas_bf16(reverse):
    params = _layer_params(4)
    x = np.random.default_rng(5).standard_normal((N, T, C)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(
        gru_apply_pallas(jax.tree.map(jnp.asarray, params), xb, reverse=reverse, interpret=True)
    ).astype(np.float32)
    got = gru.gru_apply(_torch(params), torch.from_numpy(x).to(torch.bfloat16), reverse=reverse)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


def test_cpu_tensor_takes_plain_version_without_launching():
    args = [torch.from_numpy(a) for a in _seq_inputs(6)]
    before = gru.gru_sequence.launches
    out = gru.gru_sequence(*args, reverse=True)
    assert gru.gru_sequence.launches == before
    torch.testing.assert_close(out, gru.gru_sequence_reference(*args, reverse=True), rtol=0, atol=0)


def test_gru_apply_plain_switch_matches_wrapper():
    params = _torch(_layer_params(7))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((N, T, C)).astype(np.float32))
    torch.testing.assert_close(
        gru.gru_apply(params, x, reverse=True, plain=True),
        gru.gru_apply(params, x, reverse=True),
        rtol=0,
        atol=0,
    )


def test_wrapper_rejects_bad_operands():
    xr, xz, xn, wh, bh = (torch.from_numpy(a) for a in _seq_inputs())
    with pytest.raises(TypeError):
        gru.gru_sequence(xr.double(), xz, xn, wh, bh)
    with pytest.raises(ValueError):
        gru.gru_sequence(xr, xz[:, :2], xn, wh, bh)
    with pytest.raises(ValueError):
        gru.gru_sequence(xr, xz, xn, wh[:, :H], bh)
    with pytest.raises(ValueError):
        gru.gru_sequence(xr.transpose(0, 1), xz.transpose(0, 1), xn.transpose(0, 1), wh, bh)


def test_wrapper_takes_gate_slices_of_one_projection():
    # gru_apply hands the kernel the r/z/n column slices of one [T, N, 3H]
    # tensor (row stride 3H); the wrapper accepts them as they are.
    xr, xz, xn, wh, bh = (torch.from_numpy(a) for a in _seq_inputs(9))
    packed = torch.cat([xr, xz, xn], dim=-1)
    sr, sz, sn = packed.split(H, dim=-1)
    torch.testing.assert_close(
        gru.gru_sequence(sr, sz, sn, wh, bh),
        gru.gru_sequence_reference(xr, xz, xn, wh, bh),
        rtol=0,
        atol=0,
    )


@pytest.mark.parametrize(
    "n, hidden, want",
    [
        # Above hidden 256: clusters of 16 blocks. wh's slice stays in shared
        # memory up to 384 and is read from global memory above.
        (20, 384, {"cluster": 16, "units": 24, "tiles": 2, "rows": 10, "wh_global": 0}),
        (20, 512, {"cluster": 16, "units": 32, "tiles": 2, "rows": 10, "wh_global": 1}),
        (64, 300, {"cluster": 16, "units": 19, "tiles": 4, "rows": 16, "wh_global": 0}),
        (5, 400, {"cluster": 16, "units": 25, "tiles": 1, "rows": 5, "wh_global": 1}),
        (20, 192, {"cluster": 8, "units": 24, "tiles": 2, "rows": 10, "wh_global": 0}),
    ],
)
def test_launch_plan_of_large_hidden_sizes(n, hidden, want):
    plan = gru.launch_plan(n, hidden)
    assert {k: plan[k] for k in want} == want
    assert plan["cluster"] * plan["units"] >= hidden > (plan["cluster"] - 1) * plan["units"]
    assert 0 < plan["smem"] <= gru.SMEM_LIMIT


@pytest.mark.parametrize("hidden", [513, 1024])
def test_launch_plan_refuses_hidden_sizes_above_512(hidden):
    with pytest.raises(ValueError, match="serves hidden sizes up to 512"):
        gru.launch_plan(4, hidden)
    params = {"wx": torch.zeros(3, 3 * hidden), "wh": torch.zeros(hidden, 3 * hidden),
              "bx": torch.zeros(3 * hidden), "bh": torch.zeros(3 * hidden)}
    with pytest.raises(ValueError, match="too large for the GRU kernel"):
        gru.gru_apply(params, torch.zeros(2, 5, 3))


@pytest.mark.parametrize("hidden", [300, 512])
def test_large_hidden_plain_version_matches_jax_scan(hidden):
    # On the CPU the wrapper runs the plain loop at any size the kernel
    # serves; it equals the JAX package's scan GRU there.
    rng = np.random.default_rng(hidden)
    params = {
        "wx": (rng.standard_normal((C, 3 * hidden)) * np.sqrt(2.0 / C)).astype(np.float32),
        "wh": (rng.standard_normal((hidden, 3 * hidden)) * np.sqrt(2.0 / hidden)).astype(np.float32),
        "bx": (rng.standard_normal(3 * hidden) * 0.1).astype(np.float32),
        "bh": (rng.standard_normal(3 * hidden) * 0.1).astype(np.float32),
    }
    x = rng.standard_normal((2, 5, C)).astype(np.float32)
    want = np.asarray(jnn.gru_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = gru.gru_apply(_torch(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)

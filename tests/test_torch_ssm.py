"""The port's Mamba-2 layer (``models/ssm.py``) and the plain version of its
kernel (``kernels/ssd_scan.py``) against the JAX reference, on the CPU.
Inputs come from a numpy seed and go to both sides.

Tolerances:
* ``ssd_scan_ref`` against the Pallas kernel in interpret mode, the
  sequential-recurrence oracle ``ref.ssd_scan_ref`` and the reference's
  ``_ssd_chunked`` (y and the final state): ``SSD_TOL``, rtol = atol =
  3e-4, the reference's own tolerance for its kernel
  (``tests/test_kernels.py``): f32 sums in other orders;
* the ``mamba2`` block against ``jax.jit`` of the reference's: ``BLOCK_TOL``
  on outputs of magnitude ~4 (one bf16 rounding of the out-projection at
  bf16; at W8A8 the integer GEMMs are exact and the f32 glue agrees to
  ~1e-6), the states within ``SSD_TOL``.  The reference is compiled with
  ``xla_allow_excess_precision`` off: by default XLA:CPU drops some of the
  bf16 round trips its code writes (f32 -> bf16 -> f32 before an integer
  activation quant), which the port keeps, as a TPU does.

The CUDA kernel is held against ``ssd_scan_ref`` on the card by the
``cuda``-marked test at the end (skipped without a card) and by
``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.quant import ptq_quantize_params as jptq

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models import layers, ssm
from repro_torch.quant import ptq_quantize_params

SSD_TOL = dict(rtol=3e-4, atol=3e-4)
BLOCK_TOL = dict(rtol=2.0 ** -7, atol=2e-3)
ZAMBA = "zamba2-2.7b"
# the reference compiled as its code reads: every bf16 rounding kept
EXACT = {"xla_allow_excess_precision": False}


def T(a):
    return torch.from_numpy(np.array(a))


def scan_inputs(rng, b, t, h, p, n):
    """x (B,T,H,P), dt (B,T,H) > 0, A (H,) < 0, B/C (B,T,N), f32."""
    return (rng.normal(size=(b, t, h, p)).astype(np.float32),
            (np.abs(rng.normal(size=(b, t, h))) * 0.5 + 0.01).astype(np.float32),
            (-np.abs(rng.normal(size=(h,))) - 0.1).astype(np.float32),
            rng.normal(size=(b, t, n)).astype(np.float32),
            rng.normal(size=(b, t, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# ssd_scan (B16): the plain version
# ---------------------------------------------------------------------------

class TestSSDScanPlain:
    @pytest.mark.parametrize("t,n,p,chunk", [
        (128, 16, 32, 64), (256, 64, 64, 128), (64, 8, 16, 32),
    ])
    def test_vs_pallas_and_sequential_oracle(self, rng, t, n, p, chunk):
        """``tests/test_kernels.py``'s shapes: three (lane, head) rows, each
        with its own A, B and C — one lane and one head at a time in the
        port's layout."""
        bh = 3
        x = rng.normal(size=(bh, t, p)).astype(np.float32)
        dt = (np.abs(rng.normal(size=(bh, t))) * 0.5 + 0.01).astype(np.float32)
        b = rng.normal(size=(bh, t, n)).astype(np.float32)
        c = rng.normal(size=(bh, t, n)).astype(np.float32)
        a = (-np.abs(rng.normal(size=(bh, 1))) - 0.1).astype(np.float32)
        pallas = pallas_ssd_scan(*map(jnp.asarray, (x, dt, b, c, a)),
                                 chunk=chunk, interpret=True)
        oracle = jax.jit(ref.ssd_scan_ref)(x, dt, b, c, a)
        got = torch.cat([ssd_scan_ref(T(x[i])[None, :, None], T(dt[i])[None, :, None],
                                      T(a[i]), T(b[i])[None], T(c[i])[None],
                                      chunk)[0][0, :, 0]
                         for i in range(bh)]).reshape(bh, t, p).numpy()
        np.testing.assert_allclose(got, np.asarray(pallas), **SSD_TOL)
        np.testing.assert_allclose(got, np.asarray(oracle), **SSD_TOL)

    @pytest.mark.parametrize("b,t,h,p,n,chunk", [(2, 128, 2, 32, 16, 64),
                                                  (1, 256, 3, 64, 64, 128)])
    def test_vs_model_ssd_chunked(self, rng, b, t, h, p, n, chunk):
        """y and the final state against ``repro.models.ssm._ssd_chunked``,
        B and C shared by the heads (the model's layout)."""
        args = scan_inputs(rng, b, t, h, p, n)
        yj, sj = jax.jit(lambda *a: jssm._ssd_chunked(*a, chunk=chunk))(*args)
        y, s = ops.ssd_scan(*map(T, args), chunk)
        assert y.shape == (b, t, h, p) and s.shape == (b, h, n, p)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SSD_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), **SSD_TOL)

    def test_final_state_continues_the_recurrence(self, rng):
        """The final state is the sequential recurrence's last state: the
        scan of T steps then one step equals the oracle's y at T + 1."""
        b, t, h, p, n = 1, 128, 2, 16, 8
        x, dt, a, bm, cm = scan_inputs(rng, b, t + 1, h, p, n)
        _, s = ssd_scan_ref(*(T(v) for v in (x[:, :t], dt[:, :t], a,
                                              bm[:, :t], cm[:, :t])), 64)
        h1 = (s * torch.exp(T(dt[:, t]) * T(a))[..., None, None]
              + torch.einsum("bh,bn,bhp->bhnp", T(dt[:, t]), T(bm[:, t]),
                             T(x[:, t])))
        y_next = torch.einsum("bn,bhnp->bhp", T(cm[:, t]), h1)
        xs = np.moveaxis(x, 2, 1).reshape(b * h, t + 1, p)
        dts = np.moveaxis(dt, 2, 1).reshape(b * h, t + 1)
        bs = np.broadcast_to(bm[:, None], (b, h, t + 1, n)).reshape(b * h, t + 1, n)
        cs = np.broadcast_to(cm[:, None], (b, h, t + 1, n)).reshape(b * h, t + 1, n)
        want = jax.jit(ref.ssd_scan_ref)(xs, dts, bs, cs,
                                         np.tile(a[:, None], (b, 1)))
        np.testing.assert_allclose(y_next.numpy().reshape(b * h, p),
                                   np.asarray(want)[:, t], **SSD_TOL)


# ---------------------------------------------------------------------------
# the mamba2 block against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba_blocks():
    """{precision: (reference mamba params of layer 0, the port's Mamba2,
    reference cfg, port cfg)} at zamba2-2.7b-reduced, seed 0."""
    out = {}
    for prec in ("bf16", "w8a8"):
        jcfg = jget_config(ZAMBA, precision=prec, reduced=True)
        cfg = get_config(ZAMBA, precision=prec, reduced=True)
        p = jinit_params(jax.random.PRNGKey(0), jcfg)
        tp = from_reference(jax.device_get(p), cfg, device="cpu")
        if prec == "w8a8":
            p, tp = jptq(p), ptq_quantize_params(tp)
        jm = jax.tree.map(lambda a: a[0], p["periods"][0]["mamba"])
        out[prec] = (jm, tp.layers[0].mamba, jcfg, cfg)
    return out


def _block_pair(zamba_blocks, prec, x, state):
    jm, tm, jcfg, cfg = zamba_blocks[prec]
    f = jax.jit(lambda p, x, st: jssm.mamba2(p, x, jcfg,
                                             jlayers.ExecMode(prec), state=st),
                compiler_options=EXACT)
    yj, sj = f(jm, jnp.asarray(x, jnp.bfloat16), state and jax.tree.map(
        jnp.asarray, state))
    xt = T(np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
    yt, st = ssm.mamba2(tm, xt.bfloat16(), cfg, layers.ExecMode(prec),
                        state=state and {k: T(v) for k, v in state.items()})
    return (np.asarray(yj.astype(jnp.float32)), jax.device_get(sj),
            yt.float().numpy(), {k: v.numpy() for k, v in st.items()})


@pytest.mark.parametrize("prec", ["bf16", "w8a8"])
@pytest.mark.parametrize("case", ["no_state", "state_prefill",
                                  "step_after_prefill"])
def test_mamba2_block_vs_reference(zamba_blocks, rng, prec, case):
    """Both branches: the chunked scan with no state (T = 40, padded to the
    chunk), with a state at T > 1 (the conv state carries over, the scan
    starts from zero as the reference's does), and the one-step update at
    T = 1 from the state a T > 1 prefill left."""
    cfg = zamba_blocks[prec][3]
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    st0 = {k: v.numpy() for k, v in
           ssm.init_mamba2_state(cfg, 2, "cpu").items()}
    st0["conv"] = rng.normal(size=st0["conv"].shape).astype(np.float32)
    if case == "no_state":
        yj, sj, yt, st = _block_pair(zamba_blocks, prec, x, None)
    elif case == "state_prefill":
        yj, sj, yt, st = _block_pair(zamba_blocks, prec, x, st0)
    else:
        _, sj, _, _ = _block_pair(zamba_blocks, prec, x, st0)
        state = {k: np.asarray(v) for k, v in sj.items()}
        yj, sj, yt, st = _block_pair(zamba_blocks, prec, x[:, :1], state)
    assert yt.shape == yj.shape and np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, **BLOCK_TOL)
    np.testing.assert_array_equal(st["conv"], np.asarray(sj["conv"]))
    np.testing.assert_allclose(st["ssd"], np.asarray(sj["ssd"]), **SSD_TOL)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's softplus returns
    x itself above its threshold of 20, which differs from it in the last
    bits."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = torch.logaddexp(T(x), torch.zeros(len(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_dims_match_the_reference():
    for reduced in (False, True):
        jcfg = jget_config(ZAMBA, reduced=reduced)
        cfg = get_config(ZAMBA, reduced=reduced)
        assert ssm._mamba_dims(cfg) == jssm._mamba_dims(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.has_recurrent_state and cfg.period == 6
    assert ssm._mamba_dims(get_config(ZAMBA)) == (5120, 80, 64, 64)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version (skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the "
                    "card (chip_smoke.py covers them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", [(64, 64), (64, 16)])
def test_ssd_scan_kernel_on_card(rng, cuda_dev, p, n):
    args = [T(a).to(cuda_dev) for a in scan_inputs(rng, 2, 384, 3, p, n)]
    y, s = ops.ssd_scan(*args)
    yr, sr = ssd_scan_ref(*args)
    torch.testing.assert_close(y, yr, **SSD_TOL)
    torch.testing.assert_close(s, sr, **SSD_TOL)

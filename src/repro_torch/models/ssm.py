"""State-space and recurrent blocks: Mamba2 (zamba2) and xLSTM (mLSTM,
sLSTM), the JAX package's ``models/ssm.py``.

Every block has one form for a whole sequence and for one decode step:
float32 states and an optional initial state, so that a step at T = 1
from a decode cache is the same function as the prefill.  The reference's
time scan is its paper-faithful baseline (its chunked SSD form is a
hillclimb item), and the port keeps its sequential recurrence.  As the
reference runs each recurrence as one ``lax.scan``, the port runs it as
one op (:mod:`repro_torch.kernels.ssm_scan`: S1 Mamba2, S2 mLSTM, S3
sLSTM): the plain twin's time loop on the CPU, one kernel launch with the
state on the chip on a card, shapes only on ``meta`` (the dry-run).  The
work that does not depend on the state (the projections, the causal conv,
the decay exp(dt A), dt * x, the gates' input terms) is done for all T
before the op, the output projection after it.

The route (:func:`_recurrence`) is a pure function of the operands: with
grad mode on and an operand that requires grad, the scan calls the twin
itself on either device (the ops have no autograd formula; the gradient
flows through the twin's loop); else it calls the op, whose CUDA
implementation launches the kernel or raises.

Where the two frameworks could round differently, the reference's
formulas are copied rather than PyTorch's shortcuts:

* ``softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``), not
  ``F.softplus`` with its threshold of 20, and ``log_sigmoid`` is
  ``jax.nn.log_sigmoid`` (``-softplus(-x)``);
* the causal conv is the reference's window einsum over a (B, T, W, C)
  view, not ``F.conv1d`` (cuDNN would run a float32 convolution in TF32);
* the xLSTM stabilisers start at -1e30 (float32), so the first step's
  forget term is exp(-1e30) = 0;
* the Mamba2 update ``einsum("bs,bh,bhd->bhsd")`` is written as the
  product B_t * (dt_t * x_t): the same three factors, one rounding order
  (the reference leaves its order to the einsum's contraction path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref, ssm_scan
from repro_torch.kernels.ref import log_sigmoid, softplus
from repro_torch.models.layers import init_dense

CONV_W = 4  # causal depthwise conv width used by Mamba2
NEG_INIT = -1e30  # the xLSTM stabilisers' initial value


def _recurrence(op, twin, *operands):
    """``twin(*operands)`` when grad mode is on and an operand requires
    grad (the training route: the op has no backward), else
    ``op(*operands)``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return twin(*operands)
    return op(*operands)


# =========================================================== Mamba2 (SSD)
def mamba2_dims(d_model: int, d_state: int, headdim: int = 64,
                expand: int = 2):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return d_inner, n_heads


def init_mamba2(generator, d_model, d_state, headdim=64, expand=2,
                dtype=torch.float32, device="cuda"):
    """The reference's parameter dict: in_proj (d, 2 d_inner + 2 d_state +
    H) -> [z, x, B, C, dt], conv_w (CONV_W, d_inner + 2 d_state) at scale
    0.5, A_log and dt_bias zeros and D ones (float32, (H,)), out_proj
    (d_inner, d); normal x 1/sqrt(fan_in) from ``generator``."""
    d_inner, n_heads = mamba2_dims(d_model, d_state, headdim, expand)
    d_in_proj = 2 * d_inner + 2 * d_state + n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": init_dense(generator, (d_model, d_in_proj), dtype=dtype,
                              device=device),
        "conv_w": init_dense(generator, (CONV_W, d_inner + 2 * d_state),
                             scale=0.5, dtype=dtype, device=device),
        "A_log": torch.zeros((n_heads,), **f32),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "out_proj": init_dense(generator, (d_inner, d_model), dtype=dtype,
                               device=device),
    }


def _mamba2_split(cfg_dims, proj):
    d_inner, d_state, n_heads = cfg_dims
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    Bmat = proj[..., 2 * d_inner:2 * d_inner + d_state]
    Cmat = proj[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, x, Bmat, Cmat, dt


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, T, C); w: (W, C). Returns y, new_state
    (the last W - 1 inputs, the decode cache's ``conv``)."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)             # (B, T+W-1, C)
    windows = xp.unfold(1, W, 1)                              # (B, T, C, W)
    y = torch.einsum("btcw,wc->btc", windows, w.to(x.dtype))
    return F.silu(y), xp[:, -(W - 1):]


def mamba2_scan(params, x, d_state, headdim=64, state=None, conv_state=None):
    """x: (B, T, d_model) -> (B, T, d_model), carrying (ssm, conv) state:
    ssm (B, H, d_state, headdim) float32, conv (B, CONV_W - 1, d_inner +
    2 d_state) in x's type."""
    B_, T, _ = x.shape
    d_inner = params["out_proj"].shape[0]
    n_heads = d_inner // headdim
    dims = (d_inner, d_state, n_heads)

    proj = x @ params["in_proj"]
    z, xin, Bm, Cm, dt = _mamba2_split(dims, proj)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], conv_state)
    xin = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + d_state]
    Cm = conv_out[..., d_inner + d_state:]

    A = -torch.exp(params["A_log"])                               # (H,)
    dt = softplus(dt.float() + params["dt_bias"])                 # (B,T,H)
    xh = xin.reshape(B_, T, n_heads, headdim).float()
    decay = torch.exp(dt * A)                                     # (B,T,H)
    dtx = dt[..., None] * xh                                      # (B,T,H,hd)

    s = (torch.zeros((B_, n_heads, d_state, headdim), dtype=torch.float32,
                     device=x.device) if state is None else state)
    y, s = _recurrence(ssm_scan.mamba2_scan, ref.mamba2_recurrence_plain,
                       decay, Bm.float(), Cm.float(), dtx, s)   # (B,T,H,hd)
    y = y + params["D"][None, None, :, None] * xh
    y = (y.reshape(B_, T, d_inner) * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], (s, conv_state)


# ============================================================== xLSTM
def init_mlstm(generator, d_model, n_heads, dtype=torch.float32,
               device="cuda"):
    """wq, wk, wv, wo (d, d) and the gate rows wi, wf (d, H)."""
    def w(shape):
        return init_dense(generator, shape, dtype=dtype, device=device)

    return {"wq": w((d_model, d_model)), "wk": w((d_model, d_model)),
            "wv": w((d_model, d_model)), "wi": w((d_model, n_heads)),
            "wf": w((d_model, n_heads)), "wo": w((d_model, d_model))}


def mlstm_scan(params, x, n_heads, state=None):
    """Matrix-memory LSTM (xLSTM mLSTM) with exp-gate stabilization.
    state: (C (B, H, hd, hd), n (B, H, hd), m (B, H)), float32."""
    B, T, d = x.shape
    hd = d // n_heads
    q = (x @ params["wq"]).reshape(B, T, n_heads, hd) * hd ** -0.5
    k = (x @ params["wk"]).reshape(B, T, n_heads, hd) * hd ** -0.5
    v = (x @ params["wv"]).reshape(B, T, n_heads, hd)
    log_i = (x @ params["wi"]).float()                           # (B,T,H)
    log_f = log_sigmoid((x @ params["wf"]).float())

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((B, n_heads, hd, hd), **f32),
                 torch.zeros((B, n_heads, hd), **f32),
                 torch.full((B, n_heads), NEG_INIT, **f32))
    y, C, n, m = _recurrence(ssm_scan.mlstm_scan,
                             ref.mlstm_recurrence_plain, q.float(),
                             k.float(), v.float(), log_i, log_f, *state)
    y = y.reshape(B, T, d).to(x.dtype)
    return y @ params["wo"], (C, n, m)


def init_slstm(generator, d_model, n_heads, dtype=torch.float32,
               device="cuda"):
    """The input maps wz, wi, wf, wo (d, d), the per-head recurrences rz,
    ri, rf, ro (H, hd, hd) and w_out (d, d)."""
    hd = d_model // n_heads

    def w(shape):
        return init_dense(generator, shape, dtype=dtype, device=device)

    p = {k: w((d_model, d_model)) for k in ("wz", "wi", "wf", "wo")}
    p.update({k: w((n_heads, hd, hd)) for k in ("rz", "ri", "rf", "ro")})
    p["w_out"] = w((d_model, d_model))
    return p


def slstm_scan(params, x, n_heads, state=None):
    """Scalar-memory LSTM with exponential gating + per-head recurrence.
    state: (c, n, m, h), each (B, H, hd) float32."""
    B, T, d = x.shape
    hd = d // n_heads
    gates = [(x @ params[k]).reshape(B, T, n_heads, hd).float()
             for k in ("wz", "wi", "wf", "wo")]

    if state is None:
        zeros = torch.zeros((B, n_heads, hd), dtype=torch.float32,
                            device=x.device)
        state = (zeros, zeros, torch.full_like(zeros, NEG_INIT), zeros)
    # The four recurrences h @ r (einsum "bhd,hde->bhe") in one product.
    R = torch.cat([params[k].float() for k in ("rz", "ri", "rf", "ro")], -1)
    y, c, n, m, h = _recurrence(ssm_scan.slstm_scan,
                                ref.slstm_recurrence_plain, *gates, R,
                                *state)
    y = y.reshape(B, T, d).to(x.dtype)
    return y @ params["w_out"], (c, n, m, h)

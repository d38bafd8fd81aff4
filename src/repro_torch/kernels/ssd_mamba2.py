"""Mamba2 SSD scan: the Hopper kernel, its plain version and the oracle.

``ssd_scan`` is the Hopper counterpart of the TPU kernel
``repro/kernels/ssd_mamba2.py:ssd_scan``, written for the model's mamba
block (``models/ssm.py``) and its layout:

* ``x [N, S, H, P]``, ``dt [N, S, H]`` (float32, already through
  softplus), ``a [Na, H]`` (> 0; row n takes ``a[n // (N // Na)]``, the
  model's per-rank decay rates, Na = p), ``B, C [N, S, Ns]``, ``s0 [N, H,
  Ns, P]`` or None (zeros), with N = p·B the model's ranks times requests;
* returns ``y [N, S, H, P]`` and ``s_fin [N, H, Ns, P]``, both float32,
  with ``S_t = exp(-dt_t a) S_{t-1} + B_tᵀ (dt_t x_t)`` and ``y_t = C_t
  S_t``.

B and C are shared by the heads of a row: the TPU wrapper takes them
broadcast to ``[BH, S, N]``; the kernel indexes them by row and builds no
broadcast copy (the model passes them as strided views of its conv
output).  The extensions over the TPU kernel are those of
``rwkv6_scan``: the initial state ``s0``, any S (the ragged last chunk is
masked), and ``out_state=`` that may be ``s0`` itself (the cache updated
in place).  x, B and C may be bfloat16 (converted exactly in the kernel);
dt, a and the state are float32.  The CUDA source, with its bound, is
``csrc/ssd_scan.cu``; it decides which of its kernels a call takes
(``ssd_scan_path``): at P = Ns = 64 (the model's) with rows aligned for
16-byte loads (``_vec_ok``), ``decode`` at S = 1 and ``chunked`` else;
any other P or Ns, or unaligned rows, ``general``.  The launches are
counted in ``ssd_scan.launches_by_path``.

``ssd_scan_plain`` is the TPU kernel's chunked algorithm in PyTorch over
chunks of ``CHUNK`` rows: ``C Bᵀ`` masked by the decay (the mask includes
the diagonal), the inter-chunk term ``(C ⊙ e^{cum}) S`` and the state
update.  CPU tensors take it; on the card it checks the kernel, within
``tolerance``, and is what training differentiates: ``SSDScan`` is the
``torch.autograd.Function`` whose forward is ``ssd_scan`` and whose
backward recomputes the scan through ``ssd_scan_plain`` under autograd,
the counterpart of ``jax.vjp`` of the JAX package's
``models/ssm.py:_ssd_chunked``.  ``ssd_ref`` is the oracle of
``repro/kernels/ref.py:ssd_ref`` (sequential, TPU layout).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._recompute import grads_through

CHUNK = 64                     # the kernel's chunk, as the TPU kernel's
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128                  # P and Ns: the state and a chunk fit in smem


def _lib() -> ctypes.CDLL:
    lib = _build.cuda_library("ssd_scan", ["ssd_scan.cu"])
    fn = lib.ssd_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_void_p])
        lib.ssd_scan_path.restype = ctypes.c_int
        lib.ssd_scan_path.argtypes = [ctypes.c_int] * 4
    return lib


def build() -> None:
    """Compile (once) and load the CUDA library."""
    _lib()


PATHS = ("chunked", "decode", "general")       # ssd_scan_path


def ssd_scan_path(s: int, p: int, ns: int, vec: bool) -> str:
    """The kernel a call of ``s`` rows, head dim ``p``, state ``ns`` takes
    (the C source's ``ssd_scan_path``); ``vec`` is ``_vec_ok``."""
    return PATHS[_lib().ssd_scan_path(s, p, ns, int(vec))]


def _vec_ok(x, B, C, s0=None, out_state=None) -> bool:
    """Whether the kernel may load rows of x, B and C 16 bytes at a time:
    every stride but the last a multiple of 16 bytes, and the base
    pointers of x, B, C, s0 and out_state 16-byte aligned (P and Ns are
    64 wherever it matters, so every row's 16-byte pieces are whole)."""
    def aligned(t, dims):
        per = 16 // t.element_size()
        return (t.data_ptr() % 16 == 0
                and all(st % per == 0 for st in t.stride()[:dims]))
    return (aligned(x, 3) and aligned(B, 2) and aligned(C, 2)
            and all(t is None or t.data_ptr() % 16 == 0
                    for t in (s0, out_state)))


def _check(x, dt, a, B, C, s0, out_state):
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 2 or B.dim() != 3:
        raise ValueError(f"ssd_scan takes x [N, S, H, P], dt [N, S, H], a "
                         f"[Na, H], B, C [N, S, Ns], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(B.shape)}")
    n, s, h, p = x.shape
    ns = B.shape[-1]
    if tuple(dt.shape) != (n, s, h):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} is not {(n, s, h)}")
    if a.shape[1] != h or a.shape[0] == 0 or n % a.shape[0]:
        raise ValueError(f"ssd_scan: a {tuple(a.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if tuple(B.shape) != (n, s, ns) or tuple(C.shape) != (n, s, ns):
        raise ValueError(f"ssd_scan: B {tuple(B.shape)}, C {tuple(C.shape)} "
                         f"are not [{n}, {s}, Ns]")
    for name, t in (("s0", s0), ("out_state", out_state)):
        if t is not None and tuple(t.shape) != (n, h, ns, p):
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)} is not "
                             f"{(n, h, ns, p)}")
    if B.dtype != C.dtype:
        raise ValueError(f"ssd_scan: B and C dtypes {B.dtype}, {C.dtype} "
                         "differ")


def ssd_scan_plain(x, dt, a, B, C, s0=None, *, chunk: int = CHUNK):
    """The plain PyTorch version: the TPU kernel's chunked algorithm over
    chunks of ``chunk`` rows (the last one ragged), float32 inside
    (float64 for float64 inputs).  Its decay mask clamps the exponent at
    0 before the exponential, so its gradient stays finite where the JAX
    package's ``jnp.where(tri, exp(diff), 0)`` may overflow above the
    diagonal."""
    _check(x, dt, a, B, C, s0, None)
    n, s, h, p = x.shape
    dev = x.device
    ct = torch.promote_types(x.dtype, torch.float32)
    aa = a.to(ct).repeat_interleave(n // a.shape[0], 0)     # [N, H]
    st = (torch.zeros(n, h, B.shape[-1], p, dtype=ct, device=dev)
          if s0 is None else s0.to(ct))
    y = torch.empty(n, s, h, p, dtype=ct, device=dev)
    for c0 in range(0, s, chunk):
        xc = x[:, c0:c0 + chunk].to(ct).transpose(1, 2)    # [N, H, Lc, P]
        dtc = dt[:, c0:c0 + chunk].to(ct).transpose(1, 2)  # [N, H, Lc]
        bc = B[:, c0:c0 + chunk].to(ct)                    # [N, Lc, Ns]
        cc = C[:, c0:c0 + chunk].to(ct)
        lc = xc.shape[2]
        cum = torch.cumsum(-dtc * aa[:, :, None], dim=2)
        xb = xc * dtc[..., None]
        tri = torch.ones(lc, lc, dtype=torch.bool, device=dev).tril()
        diff = cum[..., :, None] - cum[..., None, :]
        m = (cc @ bc.transpose(1, 2))[:, None] * torch.exp(
            torch.clamp(diff, max=0.0)) * tri
        yc = m @ xb + (cc[:, None] * torch.exp(cum)[..., None]) @ st
        y[:, c0:c0 + lc] = yc.transpose(1, 2)
        last = cum[..., -1]                                 # [N, H]
        bdec = bc[:, None] * torch.exp(last[..., None] - cum)[..., None]
        st = torch.exp(last)[..., None, None] * st + \
            bdec.transpose(-1, -2) @ xb
    return y, st


def ssd_scan(x, dt, a, B, C, s0=None, *, out_state=None):
    """The scan on the model's layout (see the module docstring).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (the
    last dim of x, B and C must be contiguous, other dims may be strided
    views; s0 and out_state contiguous)."""
    _check(x, dt, a, B, C, s0, out_state)
    ts = [t for t in (x, dt, a, B, C, s0, out_state) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        y, s_fin = ssd_scan_plain(x, dt, a, B, C, s0)
        if out_state is not None:
            out_state.copy_(s_fin)
            s_fin = out_state
        return y, s_fin
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("ssd_scan: tensors on "
                         f"{sorted({str(t.device) for t in ts})}")
    if x.dtype not in _DTYPE_CODE or B.dtype not in _DTYPE_CODE:
        raise ValueError(f"ssd_scan takes x, B, C in float32/bfloat16, got "
                         f"{x.dtype}, {B.dtype}")
    for name, t in (("dt", dt), ("a", a), ("s0", s0),
                    ("out_state", out_state)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} must be float32, got "
                             f"{t.dtype}")
    n, s, h, p = x.shape
    ns = B.shape[-1]
    if p > MAX_DIM or ns > MAX_DIM:
        raise ValueError(f"ssd_scan: head dim {p} or state {ns} > {MAX_DIM}")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("ssd_scan needs a contiguous last dim of x, B, C")
    if any(t is not None and not t.is_contiguous() for t in (s0, out_state)):
        raise ValueError("ssd_scan needs a contiguous s0 and out_state")
    y = torch.empty(n, s, h, p, dtype=torch.float32, device=dev)
    s_out = (out_state if out_state is not None else
             torch.empty(n, h, ns, p, dtype=torch.float32, device=dev))
    if n * h == 0:
        return y, s_out
    stream = torch.cuda.current_stream(dev).cuda_stream
    vec = _vec_ok(x, B, C, s0, s_out)
    path = ssd_scan_path(s, p, ns, vec)
    rc = _lib().ssd_scan(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[B.dtype], x.data_ptr(),
        dt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_out.data_ptr(), n, s, h, p, ns, a.shape[0], *x.stride()[:3],
        *dt.stride(), *a.stride(), *B.stride()[:2], *C.stride()[:2],
        int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_path[path] += 1
    return y, s_out


ssd_scan.launches = 0
ssd_scan.launches_by_path = dict.fromkeys(PATHS, 0)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` from a zero state under autograd: ``SSDScan.apply(x,
    dt, a, B, C) -> y``, gradients for all five (B and C may be views of
    one tensor).  The forward is ``ssd_scan`` (the kernel on CUDA tensors,
    the plain version on CPU ones) and saves its inputs; the backward
    recomputes ``y`` through ``ssd_scan_plain`` under autograd."""

    @staticmethod
    def forward(ctx, x, dt, a, B, C):
        ctx.save_for_backward(x, dt, a, B, C)
        return ssd_scan(x, dt, a, B, C)[0]

    @staticmethod
    def backward(ctx, g):
        return tuple(grads_through(
            lambda *ins: ssd_scan_plain(*ins)[0], ctx.saved_tensors,
            ctx.needs_input_grad, g))


def tolerance(x, dt, a, B, C, s0=None):
    """The elementwise limits ``(y_lim, s_lim)`` on ``|ssd_scan -
    ssd_scan_plain|`` for these inputs.

    As ``rwkv6_scan.tolerance``: each output is a sum of products
    ``C·B·dt·x`` (and ``C·s0``) times decay factors <= 1; M is that sum
    over the terms' absolute values (the plain version on ``|x|, |B|,
    |C|, |s0|``).  Summation order moves an output by ~(L + Ns)·2^-24·M,
    and the cumsums of ``-dt·a``, added in another order, by a few float32
    steps of their largest value in a chunk, ``L·max(dt·a)``.  The limit
    is 16 times both: ``(2^-20·(L + Ns) + 2^-20·L·max(dt·a))·M``.  A
    planted fault (the carried state dropped, the mask's diagonal left
    out, a row not written) moves an output by a term of M itself."""
    y_abs, s_abs = ssd_scan_plain(x.abs(), dt, a, B.abs(), C.abs(),
                                  None if s0 is None else s0.abs())
    n, _, h, _ = x.shape
    aa = a.float().repeat_interleave(n // a.shape[0], 0)
    da = float((dt.float() * aa[:, None]).abs().max())
    f = 2.0 ** -20 * (CHUNK + B.shape[-1]) + 2.0 ** -20 * CHUNK * da
    tiny = torch.finfo(torch.float32).tiny
    return f * y_abs + tiny, f * s_abs + tiny


def to_model_layout(x, dt, a, B, C):
    """TPU layout ``x [BH, S, P]``, ``dt [BH, S]``, ``a [BH]``, ``B, C [BH,
    S, N]`` -> model-layout views (one head per row; no copies)."""
    return x.unsqueeze(2), dt.unsqueeze(2), a.unsqueeze(1), B, C


def ssd_scan_bhsd(x, dt, a, B, C):
    """The TPU kernel's function and layout: ``(y [BH, S, P], s_fin [BH,
    N, P])`` float32 (s0 = zeros); it goes through ``ssd_scan``."""
    y, s_fin = ssd_scan(*to_model_layout(x, dt, a, B, C))
    return y[:, :, 0], s_fin[:, 0]


def ssd_ref(x, dt, a, B, C, s0=None):
    """The oracle (``repro/kernels/ref.py:ssd_ref``): the recurrence step by
    step in float32, TPU layout ``x [BH, S, P]``, ``dt [BH, S]``, ``a
    [BH]``, ``B, C [BH, S, N]``, ``s0 [BH, N, P]``."""
    bh, s, p = x.shape
    st = (torch.zeros(bh, B.shape[-1], p, dtype=torch.float32,
                      device=x.device) if s0 is None else s0.float())
    ys = []
    for t in range(s):
        dec = torch.exp(-dt[:, t] * a).float()
        xb = (x[:, t] * dt[:, t][:, None]).float()
        st = dec[:, None, None] * st + B[:, t].float()[:, :, None] * \
            xb[:, None, :]
        ys.append(torch.einsum("bn,bnp->bp", C[:, t].float(), st))
    return torch.stack(ys, 1), st

"""GroupNorm (+ ReLU): kernels K4a (forward) and K4b (backward) and their
plain versions.

Counterpart of ``sipmask_tpu/ops/pallas/group_norm.py:fused_gn_relu`` (its
forward ``_fwd_impl`` and backward ``_vjp_bwd``) and of
``sipmask_tpu/models/layers.py:group_norm_nhwc`` + relu. :func:`gn_relu` is a
``torch.autograd.Function`` on every device: on CUDA tensors its forward
launches K4a and its backward K4b (``csrc/gn_relu.cu``); on CPU tensors they
are :func:`gn_relu_plain`'s arithmetic and :func:`gn_relu_backward_plain`.

Layout: x and the result (B, C, H, W), f32 or bf16 (the JAX package's
``compute_dtype="bfloat16"``: f32 sums and statistics, the result in x's
dtype, ``group_norm.py:81,154``); weight and bias (C,) f32; the saved
statistics ``stats`` (B, groups, 2) f32, each group's (mean, rstd). The
kernels count their f32 calls in ``launches`` and their bf16 calls in
``bf16_launches``. In bf16 a call is one pass over HBM, one launch of a
kernel whose thread-block clusters each hold an (image, group) on chip,
wherever the slab fits (every preset's shapes); :func:`gn_schedule` mirrors
that plan on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.trace import spanned
from . import custom, native


def _check(x, weight, bias, groups):
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or not weight.dtype == bias.dtype == torch.float32):
        raise TypeError(f"x float32 or bfloat16 with float32 weight and "
                        f"bias, got {x.dtype}, {weight.dtype}, "
                        f"{bias.dtype}")
    if not x.device == weight.device == bias.device:
        raise ValueError("x, weight and bias must share a device")


def _stats_plain(x, groups: int, eps: float):
    """The single-pass-variance group statistics of
    ``layers._gn_fwd_impl``: (mean, rstd), each (B, groups)."""
    b, c, h, w = x.shape
    s1 = x.sum((2, 3))                   # (B, C)
    s2 = (x * x).sum((2, 3))
    n = float(h * w * (c // groups))
    mean = s1.reshape(b, groups, -1).sum(-1) / n
    var = s2.reshape(b, groups, -1).sum(-1) / n - mean * mean
    return mean, torch.rsqrt(var + eps)


def _affine(weight, bias, mean, rstd):
    """Per-(image, channel) (sc, bi), each (B, C): y = x*sc + bi."""
    b, groups = mean.shape
    g_sc = weight.reshape(groups, -1)
    sc = (rstd[:, :, None] * g_sc).reshape(b, -1)
    bi = (bias.reshape(groups, -1) -
          (mean * rstd)[:, :, None] * g_sc).reshape(b, -1)
    return sc, bi


def _pre_relu(x, sc, bi):
    """x*sc + bi per (image, channel) in f64, where it is the exact value
    (a product of two f32 numbers is exact there) that K4a's and K4b's
    fmaf(x, sc, bi) rounds once: its sign is their ReLU mask even where
    x*sc + bi rounded twice in f32 would land on the other side of 0, and
    rounded to f32 it is their y."""
    return torch.addcmul(bi.double()[:, :, None, None], x.double(),
                         sc.double()[:, :, None, None])


def _forward_plain(x, weight, bias, groups: int, eps: float, act: bool):
    """(y, stats) of the single-pass-variance GroupNorm of
    ``layers._gn_fwd_impl``, then a ReLU when ``act``; a bf16 x is widened
    to f32 and y rounded once to bf16."""
    _check(x, weight, bias, groups)
    xf = x.float()
    mean, rstd = _stats_plain(xf, groups, eps)
    sc, bi = _affine(weight, bias, mean, rstd)
    y = _pre_relu(xf, sc, bi).float()
    y = torch.relu(y) if act else y
    return y.to(x.dtype), torch.stack([mean, rstd], -1)


def gn_relu_plain(x, weight, bias, groups: int = 32, eps: float = 1e-5,
                  act: bool = True):
    """Plain PyTorch K4a, differentiable by autograd."""
    return _forward_plain(x, weight, bias, groups, eps, act)[0]


def _bwd_coefficients(r1, r2, weight, stats, n: float):
    """``group_norm._vjp_bwd``'s (B, C) algebra: from r1 = sum dy_eff and
    r2 = sum dy_eff*x per (image, channel), the coefficients (a, b2, c2) of
    dx = a*dy_eff + b2*x + c2, and d weight, d bias.

    In K4b's order (``csrc/gn_relu.cu:gn_bwd_apply_kernel``), so that the
    plain version pins the kernel's arithmetic: sdx = (r2 - mean*r1)*rstd,
    then per (image, group) m1 = sum_j w_j*r1_j / n and m2 = sum_j
    w_j*sdx_j / n over the group's channels j in order; a = rstd*w,
    b2 = -(rstd*rstd)*m2, c2 = rstd*((mean*rstd)*m2 - m1); d weight and
    d bias sum sdx and r1 over the images in order."""
    b, c = r1.shape
    mean, rstd = stats.unbind(-1)            # (B, G)
    groups = mean.shape[1]
    cg = c // groups

    def per_channel(t):                      # (B, G) -> (B, C)
        return t.repeat_interleave(cg, 1)
    mean_c, rstd_c = per_channel(mean), per_channel(rstd)
    sdx = (r2 - mean_c * r1) * rstd_c        # sum dy_eff * xhat per (B, C)
    w_r1 = (weight * r1).reshape(b, groups, cg)
    w_sdx = (weight * sdx).reshape(b, groups, cg)
    m1, m2 = w_r1[..., 0], w_sdx[..., 0]
    for j in range(1, cg):
        m1, m2 = m1 + w_r1[..., j], m2 + w_sdx[..., j]
    m1_c, m2_c = per_channel(m1 / n), per_channel(m2 / n)
    a = rstd_c * weight[None]
    b2 = -(rstd_c * rstd_c) * m2_c
    c2 = rstd_c * (mean_c * rstd_c * m2_c - m1_c)
    dweight, dbias = sdx[0], r1[0]
    for i in range(1, b):
        dweight, dbias = dweight + sdx[i], dbias + r1[i]
    return a, b2, c2, dweight, dbias


def gn_relu_backward_plain(x, weight, bias, stats, dy, groups: int,
                           act: bool):
    """Plain PyTorch K4b: ``layers._gn_vjp_bwd`` with the ReLU mask
    recomputed from x, as ``group_norm._vjp_bwd`` does (the sign of
    :func:`_pre_relu`, K4b's fmaf). Returns (dx,
    d weight, d bias). bf16 x and dy are widened to f32 and dx rounded once
    to bf16; d weight and d bias are f32."""
    b, c, h, w = x.shape
    dtype, x, dy = x.dtype, x.float(), dy.float()
    if act:
        sc, bi = _affine(weight, bias, *stats.unbind(-1))
        dy = torch.where(_pre_relu(x, sc, bi) > 0, dy, torch.zeros_like(dy))
    r1 = dy.sum((2, 3))
    r2 = (dy * x).sum((2, 3))
    a, b2, c2, dweight, dbias = _bwd_coefficients(
        r1, r2, weight, stats, float(h * w * (c // groups)))
    dx = (a[:, :, None, None] * dy + b2[:, :, None, None] * x +
          c2[:, :, None, None])
    return dx.to(dtype), dweight, dbias


def _lib():
    lib = native.load("gn_relu")
    if lib.gn_relu_f32.argtypes is None:
        for fn in (lib.gn_relu_f32, lib.gn_relu_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
        tail = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
        lib.gn_relu_bwd_f32.restype = ctypes.c_int
        lib.gn_relu_bwd_f32.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.gn_relu_bwd_bf16.restype = ctypes.c_int
        lib.gn_relu_bwd_bf16.argtypes = [ctypes.c_void_p] * 10 + tail
        lib.gn_relu_bf16_plan.restype = None
        lib.gn_relu_bf16_plan.argtypes = [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    return lib


# The bf16 kernels' one-pass plan (csrc/gn_relu.cu:one_plan, one_vec): a
# thread holds up to ONE_HELD vectors of each tensor; K (1, 2, 4 or 8) is
# the smallest cluster whose CTAs of at most ONE_TARGET threads hold the
# slab and whose call has ONE_MIN_CTAS CTAs; a CTA then has the threads
# for half of ONE_HELD vectors each if ONE_TARGET suffice, else for
# ONE_HELD, in whole warps (at least ONE_MIN_THREADS); past
# ONE_MAX_THREADS a CTA (forward, backward), or Cg > ONE_MAX_CG, a call
# takes the two-pass kernels.
ONE_HELD, ONE_TARGET, ONE_MIN_THREADS, ONE_MAX_CLUSTER = 8, 256, 128, 8
ONE_MIN_CTAS = 256
ONE_MAX_THREADS = {False: 1024, True: 512}
ONE_MAX_CG = 64


def _one_vec(slab: int, ptrs: int) -> int:
    """Elements a one-pass vector: 8 (16 bytes), 4 (8 bytes) or 1, by the
    slab's length and the pointers' alignment (``ptrs``: their bitwise or)."""
    if slab % 8 == 0 and ptrs % 16 == 0:
        return 8
    if slab % 4 == 0 and ptrs % 8 == 0:
        return 4
    return 1


@functools.lru_cache(maxsize=None)
def _one_plan(nvec: int, slabs: int, cg: int, backward: bool):
    """(one, K, T, per): whether a call on ``slabs`` slabs of ``nvec``
    vectors takes the cluster kernel, its cluster size, threads a CTA and
    vectors a CTA."""
    k = 1
    while k < ONE_MAX_CLUSTER and (-(-nvec // k) > ONE_HELD * ONE_TARGET
                                   or slabs * k < ONE_MIN_CTAS):
        k *= 2
    per = -(-nvec // k)

    def warps(held):   # threads for `held` vectors a thread, whole warps
        return -(-(-(-per // held)) // 32) * 32
    t = warps(ONE_HELD // 2)   # half of ONE_HELD while ONE_TARGET suffice
    if t > ONE_TARGET:
        t = warps(ONE_HELD)
    t = max(ONE_MIN_THREADS, t)
    one = nvec > 0 and cg <= ONE_MAX_CG and t <= ONE_MAX_THREADS[backward]
    return one, k, t, per


def gn_schedule(b: int, c: int, hw: int, groups: int,
                dtype=torch.bfloat16, offsets: bool = True):
    """How ``csrc/gn_relu.cu`` cuts a K4a and a K4b call on x (b, c, h, w)
    with h*w = ``hw`` in ``dtype`` (pointers aligned for 16-byte vectors),
    in plain PyTorch, for the tests. Returns a dict with "forward" and
    "backward", each with ``path`` ("one-pass": one launch of the cluster
    kernel; "two-pass": the two launches of 4096-element chunks, always in
    f32), and on the one-pass path ``cluster`` (K), ``ctas`` (K*b*groups),
    ``threads`` a CTA, ``vector_bytes``, ``elements_a_thread`` (the most a
    thread holds of a tensor), ``held_bytes`` (the most a CTA holds, of x,
    and of x and dy backward), and ``loads`` / ``stores``: (ctas, threads,
    ONE_HELD) byte offsets into x (backward: the same into dy) and y (dx)
    of each thread's vectors, -1 none (left out without ``offsets``). The
    forward holds its share in registers, the backward in shared memory
    (TMA bulk copies of the share). The tests check that every element is
    loaded once and stored once."""
    cg = c // groups
    slab = cg * hw
    out = {}
    for backward in (False, True):
        vec = _one_vec(slab, 0)
        one, k, t, per = _one_plan(slab // vec, b * groups, cg, backward)
        if dtype != torch.bfloat16 or not one:
            out["backward" if backward else "forward"] = {"path": "two-pass"}
            continue
        esize = 2
        nvec = slab // vec
        plan = {"path": "one-pass", "cluster": k, "ctas": b * groups * k,
                "threads": t, "vector_bytes": vec * esize}
        out["backward" if backward else "forward"] = plan
        if not offsets:
            continue
        cta = torch.arange(b * groups * k)
        bg, rank = cta // k, cta % k
        lo = rank * per
        n = torch.clamp(nvec - lo, 0, per)
        e = (torch.arange(t)[:, None] + t * torch.arange(ONE_HELD)
             )[None]                                     # (1, t, held)
        live = e < n[:, None, None]
        off = ((bg * slab)[:, None, None] + (lo[:, None, None] + e) * vec
               ) * esize
        off = torch.where(live, off, -1)
        plan.update(elements_a_thread=int(live.sum(-1).max()) * vec,
                    held_bytes=int(n.max()) * vec * esize * (1 + backward),
                    loads=off, stores=off)
    return out


def _cuda_check(x, weight, bias, groups):
    if x.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {x.device}")
    _check(x, weight, bias, groups)
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous")
    b, c = x.shape[:2]
    if b * max(groups, c) > 65535:
        raise ValueError(f"grid too large for B={b}, C={c}")


# elements of a slab per block of K4a (kChunk in csrc/gn_relu.cu): sizes
# the scratch of its partials, which the launcher checks
_CHUNK = 256 * 16


@spanned("sipmask.K4a")
def gn_relu_forward(x, weight, bias, groups: int = 32, eps: float = 1e-5,
                    act: bool = True, keep_stats: bool = True):
    """K4a: (y, stats), stats None unless ``keep_stats``. CPU tensors take
    the plain arithmetic; CUDA tensors launch the kernels (contiguous; x f32
    or bf16, weight and bias f32): bf16 one launch of the cluster kernel
    where :func:`gn_schedule` says "one-pass", else two launches, nothing
    between them; the wrapper only checks and allocates y and a scratch
    (stats is a view of it; the two passes' partials follow it). Raises on
    anything the kernels do not take. Records no gradient: :func:`gn_relu`
    does."""
    if x.device.type == "cpu":
        y, stats = _forward_plain(x, weight, bias, groups, eps, act)
        return y, (stats if keep_stats else None)
    _cuda_check(x, weight, bias, groups)
    b, c, h, w = x.shape
    bf16 = x.dtype == torch.bfloat16
    slab = c // groups * h * w
    y = torch.empty_like(x)
    n_stats = b * groups * 2 if keep_stats else 0
    n_scratch = n_stats
    # the two-pass kernels' partials; the bf16 cluster kernel takes none
    if not (bf16 and _one_plan(
            slab // _one_vec(slab, x.data_ptr() | y.data_ptr()), b * groups,
            c // groups, False)[0]):
        n_scratch += b * groups * 2 * -(-slab // _CHUNK)
    scratch = (torch.empty((n_scratch,), device=x.device,
                           dtype=torch.float32) if n_scratch else None)
    stats = scratch[:n_stats].view(b, groups, 2) if keep_stats else None
    if y.numel() == 0:
        return y, stats
    lib = _lib()
    launch = lib.gn_relu_bf16 if bf16 else lib.gn_relu_f32
    with native.device_guard(x.device):
        code = launch(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n_scratch,
            y.data_ptr(), b, c, h * w, groups, eps, int(act),
            int(keep_stats), native.stream_ptr(x.device))
    native.check_launch(lib, "gn_relu", code)
    if bf16:
        gn_relu.bf16_launches += 1
    else:
        gn_relu.launches += 1
    return y, stats


# (device index, stream) -> the bf16 K4b cluster kernel's per-group arrival
# counters: zeros, which every call leaves zero
_ARRIVALS = {}


def _arrivals(device, stream: int, groups: int):
    key = (device.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < groups:
        buf = torch.zeros((max(groups, 64),), device=device,
                          dtype=torch.int32)
        _ARRIVALS[key] = buf
    return buf


@spanned("sipmask.K4b")
def gn_relu_backward(x, weight, bias, stats, dy, groups: int, act: bool):
    """K4b: (dx, d weight, d bias) from the forward's ``stats``. CPU
    tensors take :func:`gn_relu_backward_plain`; CUDA tensors launch the
    kernels: bf16 one launch of the cluster kernel where :func:`gn_schedule`
    says "one-pass", else two launches, nothing between them. The wrapper
    only checks and allocates (and keeps the cluster kernel's arrival
    counters for each device and stream, zeros between calls)."""
    if x.device.type == "cpu":
        return gn_relu_backward_plain(x, weight, bias, stats, dy, groups, act)
    _cuda_check(x, weight, bias, groups)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x")
    b, c, h, w = x.shape
    if tuple(stats.shape) != (b, groups, 2) or not stats.is_contiguous():
        raise ValueError(f"stats {tuple(stats.shape)} must be contiguous "
                         f"({b}, {groups}, 2)")
    dy = dy.contiguous()
    r = torch.empty((b, c, 2), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(bias)
    if b == 0:
        return dx, dweight.zero_(), dbias.zero_()
    lib = _lib()
    stream = native.stream_ptr(x.device)
    ptrs = (x.data_ptr(), dy.data_ptr(), stats.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), r.data_ptr(), dx.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr())
    with native.device_guard(x.device):
        if x.dtype == torch.bfloat16:
            code = lib.gn_relu_bwd_bf16(
                *ptrs, _arrivals(x.device, stream, groups).data_ptr(), b, c,
                h * w, groups, int(act), stream)
        else:
            code = lib.gn_relu_bwd_f32(*ptrs, b, c, h * w, groups, int(act),
                                       stream)
    native.check_launch(lib, "gn_relu", code)
    if x.dtype == torch.bfloat16:
        gn_relu_backward.bf16_launches += 1
    else:
        gn_relu_backward.launches += 1
    return dx, dweight, dbias


gn_relu_backward.launches = 0
gn_relu_backward.bf16_launches = 0


class _GNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act):
        y, stats = gn_relu_forward(x, weight, bias, groups, eps, act)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.groups, ctx.act = groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dweight, dbias = gn_relu_backward(x, weight, bias, stats, dy,
                                              ctx.groups, ctx.act)
        return dx, dweight, dbias, None, None, None


def gn_relu(x, weight, bias, groups: int = 32, eps: float = 1e-5,
            act: bool = True):
    """GroupNorm(groups) with a per-channel affine, then ReLU when ``act``;
    differentiable in x, weight and bias. Kernels K4a/K4b on CUDA tensors,
    their plain versions on CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K4 kernel for device {x.device}")
    if custom.routed():   # torch.export: K4a as a custom op
        return torch.ops.sipmask.gn_relu(x.contiguous(), weight, bias,
                                         groups, eps, act)
    # the statistics are kept, and the autograd Function entered, only for
    # a backward that can happen
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GNReLU.apply(x, weight, bias, groups, eps, act)
    return gn_relu_forward(x, weight, bias, groups, eps, act, False)[0]


gn_relu.launches = 0
gn_relu.bf16_launches = 0

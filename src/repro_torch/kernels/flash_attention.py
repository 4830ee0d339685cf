"""Flash-decoding attention: wrappers, plain versions and launch counters of
the hand-written Hopper kernel pair ``csrc/flash_attention.cu``.

Port of ``src/repro/kernels/flash_attention.py`` (the Pallas kernel
``_kernel`` and its wrapper ``flash_decode_attention``), held against it and
against ``kernels/ref.py`` by ``tests/test_torch_attention.py``, and on the
card by ``chip_smoke.py``.

The TPU kernel walks the S blocks of one (batch, kv head) in a sequential
grid axis with an f32 online-softmax carry.  Here S is cut into splits of
``block_s`` positions and the work is two passes that share one layout of
partials, ``m``/``l`` of shape (B, H, nsplit) and ``acc`` (B, H, nsplit, d),
all float32:

  * :func:`flash_partial` — each split's ``(m, l, acc)``: ``m`` the row max
    of the split's scores ``(q . k) * d**-0.5``, ``l`` the sum of
    ``p = exp(s - m)`` and ``acc`` the sum of ``p * v``.  Positions at or
    beyond ``length[b]`` add exactly nothing; a split wholly beyond it is
    exactly ``(NEG_INF, 0, 0)``.
  * :func:`flash_combine` — folds the splits in a fixed order, optionally
    starting from an incoming ``(m, l, acc)`` carry of shapes (B, H) and
    (B, H, d): it writes the carry back in place, or normalises
    (``acc / max(l, 1e-20)``) into an output dtype.  Its arithmetic is
    ``merge_attention_partials``'s; the plain version adds the splits one
    after another, the kernel in chunks that its warps then add in order,
    so the two agree to rounding.

:func:`flash_decode_attention` is the reference contract built from the
two.  Every entry point has a plain PyTorch version with the same contract
(``*_plain``); a CPU tensor runs it, a CUDA tensor launches the kernel or
raises.  ``flash_partial.launches`` and ``flash_combine.launches`` count
kernel launches, and nothing else (under a lock: the hybrid members launch
from several threads).

On a card both passes run as operators of their own,
``torch.ops.repro_torch.flash_partial`` and ``flash_combine``: the CUDA
implementation launches the kernel and counts it (``launches``, and
``launches_by_path`` under the wrapper's ``path=``), the fake one (for a
``FakeTensorMode`` trace, ``launch.dryrun``) launches nothing, and a flop
formula counts each pass at its own work (``torch.utils.flop_counter``):
the partial pass ``4 B H S d`` (scores and ``p @ v`` over all S positions,
since a fake trace cannot read the lengths), the combine ``2 B H n d``.

``NEG_INF`` is the finite -1e30 everywhere, so two empty partials meet as
``exp(0) * 0`` and never as ``-inf - -inf``.  KV types: float32, bfloat16
and float16, read in their own dtype; q is computed in float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import count_launch

NEG_INF = -1e30
L_FLOOR = 1e-20            # normalisation clamps l here (reference :65)
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_c_void_p = ctypes.c_void_p
_c_ll = ctypes.c_longlong
_c_int = ctypes.c_int

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Length = Union[int, torch.Tensor]


def nsplits(S: int, block_s: int) -> int:
    """Number of ``block_s``-position splits covering S positions."""
    return -(-S // block_s)


def empty_partials(B: int, H: int, nsplit: int, d: int,
                   device=None) -> Partials:
    """Uninitialised (m, l, acc) partials in the layout both passes share."""
    kw = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, H, nsplit), **kw),
            torch.empty((B, H, nsplit), **kw),
            torch.empty((B, H, nsplit, d), **kw))


def _lengths(length: Length, B: int, S: int, device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        lens = length.to(device=device, dtype=torch.int64).reshape(B)
    else:
        lens = torch.full((B,), int(length), dtype=torch.int64,
                          device=device)
    return lens.clamp(min=0, max=S)


def _check(q, k, v, block_s: int) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q (B, H, d) and k, v "
                         f"(B, S, Hkv, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, d = q.shape
    _, S, hkv, _ = k.shape
    if tuple(k.shape) != (B, S, hkv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv < 1 or H % hkv != 0:
        raise ValueError(f"query heads {H} are not a multiple of kv heads "
                         f"{hkv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if S < 1:
        raise ValueError("the KV cache has no positions")
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError("k and v must share one of float32, bfloat16, "
                        f"float16; got {k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must share one device")
    if isinstance(block_s, bool) or not isinstance(block_s, int) \
            or block_s < 1:
        raise ValueError(f"block_s must be a positive int, got {block_s!r}")
    return B, H, d, S, hkv, H // hkv


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def flash_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        length: Length, *, block_s: int = 512) -> Partials:
    """The plain version of the partial pass (same contract)."""
    B, H, d, S, hkv, G = _check(q, k, v, block_s)
    n = nsplits(S, block_s)
    pad = n * block_s - S
    qf = q.float().reshape(B, hkv, G, d)
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .reshape(B, n, block_s, hkv, d) for t in (k, v))
    s = torch.einsum("bkgd,bnskd->bkgns", qf, kf) * (1.0 / math.sqrt(d))
    pos = torch.arange(n * block_s, device=q.device).reshape(n, block_s)
    lens = _lengths(length, B, S, q.device)
    mask = (pos[None] < lens[:, None, None])[:, None, None]   # (B,1,1,n,bs)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1).clamp(min=NEG_INF)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgns,bnskd->bkgnd", p, vf)
    return (m.reshape(B, H, n).contiguous(),
            p.sum(-1).reshape(B, H, n).contiguous(),
            acc.reshape(B, H, n, d).contiguous())


def flash_combine_plain(partials: Optional[Partials], *,
                        carry: Optional[Partials] = None,
                        normalise: bool = False,
                        out_dtype: torch.dtype = torch.float32):
    """The plain version of the combine pass: the folded ``(m, l, acc)``,
    or with ``normalise`` the output ``acc / max(l, 1e-20)`` in
    ``out_dtype`` (same contract as :func:`flash_combine`, returning new
    tensors)."""
    ms, ls, accs = [], [], []
    if carry is not None:
        ms.append(carry[0])
        ls.append(carry[1])
        accs.append(carry[2])
    if partials is not None:
        m, l, acc = partials
        ms += m.unbind(-1)
        ls += l.unbind(-1)
        accs += acc.unbind(-2)
    if not ms:
        raise ValueError("nothing to combine: no partials and no carry")
    m_star = ms[0]
    for mi in ms[1:]:
        m_star = torch.maximum(m_star, mi)
    l_sum = torch.zeros_like(ls[0])
    a_sum = torch.zeros_like(accs[0])
    for mi, li, ai in zip(ms, ls, accs):
        w = torch.exp(mi - m_star)
        l_sum = l_sum + li * w
        a_sum = a_sum + ai * w[..., None]
    if normalise:
        return (a_sum / l_sum.clamp(min=L_FLOOR)[..., None]).to(out_dtype)
    return m_star, l_sum, a_sum


def flash_decode_attention_plain(q, k, v, length: Length, *,
                                 block_s: int = 512) -> torch.Tensor:
    """The plain version of :func:`flash_decode_attention`."""
    return flash_combine_plain(
        flash_partial_plain(q, k, v, length, block_s=block_s),
        normalise=True, out_dtype=q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    if lib.repro_flash_partial.argtypes is None:  # pointers as c_void_p
        lib.repro_flash_partial.restype = _c_int
        lib.repro_flash_partial.argtypes = (
            [_c_int, _c_int] + [_c_void_p] * 4 + [_c_ll] + [_c_void_p] * 3
            + [_c_ll, _c_ll] + [_c_int] * 5 + [_c_ll] * 6
            + [ctypes.c_float, _c_void_p])
        lib.repro_flash_combine.restype = _c_int
        lib.repro_flash_combine.argtypes = (
            [_c_int] + [_c_void_p] * 3 + [_c_int] + [_c_void_p] * 4
            + [_c_ll] * 3 + [_c_int] * 3 + [_c_void_p])
    return lib


def _check_partials(parts: Partials, B: int, H: int, n: int, d: int,
                    device) -> None:
    shapes = ((B, H, n), (B, H, n), (B, H, n, d))
    for t, shape in zip(parts, shapes):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(
                f"partials must be contiguous float32 {shapes} on {device}, "
                f"got {[(tuple(x.shape), x.dtype, str(x.device),
                         x.is_contiguous()) for x in parts]}")


def _vector_ok(k: torch.Tensor, v: torch.Tensor) -> bool:
    """16-byte loads need 16-byte aligned rows: d, the strides and the base
    pointers all multiples of one 16-byte chunk."""
    vec = 16 // k.element_size()
    return (k.shape[-1] % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in (k, v))
            and all(s % vec == 0 for t in (k, v) for s in t.stride()[:3]))


# the two passes as operators: a CUDA implementation that launches the
# kernel, a fake one that launches nothing, and their flop formulas
_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("flash_partial(Tensor q, Tensor k, Tensor v, Tensor? lens, "
            "int len_all, Tensor(a!) m, Tensor(b!) l, Tensor(c!) acc, "
            "int block_s, str path) -> ()")
_OPS.define("flash_combine(Tensor? m, Tensor? l, Tensor? acc, "
            "Tensor(a!)? mc, Tensor(b!)? lc, Tensor(c!)? ac, "
            "Tensor(d!)? out, bool normalise, str path) -> ()")


def _partial_cuda(q, k, v, lens, len_all, m, l, acc, block_s, path):
    B, H, d = q.shape
    _, S, hkv, _ = k.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_flash_partial(
            _DTYPE_CODE[k.dtype], int(_vector_ok(k, v)), q.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), len_all,
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, S, hkv, H // hkv,
            d, block_s, m.shape[-1], *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_partial kernel launch failed: CUDA error "
                           f"{err} (B={B}, S={S}, H={H}, Hkv={hkv}, d={d}, "
                           f"dtype={k.dtype}, block_s={block_s})")
    count_launch(flash_partial, path=path or None)


def _combine_cuda(m, l, acc, mc, lc, ac, out, normalise, path):
    ref = mc if mc is not None else m
    B, H = ref.shape[:2]
    d = (ac if ac is not None else acc).shape[-1]
    n = 0 if m is None else m.shape[-1]
    ptr = lambda t: None if t is None else t.data_ptr()     # noqa: E731
    out_dtype = out.dtype if out is not None else torch.float32
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = _lib().repro_flash_combine(
            _DTYPE_CODE[out_dtype], ptr(m), ptr(l), ptr(acc), n, ptr(mc),
            ptr(lc), ptr(ac), ptr(out),
            0 if out is None else out.stride(0),
            0 if out is None else out.stride(1), B, H, d, int(normalise),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_combine kernel launch failed: CUDA error "
                           f"{err} (B={B}, H={H}, d={d}, splits={n})")
    count_launch(flash_combine, path=path or None)


_OPS.impl("flash_partial", _partial_cuda, "CUDA")
_OPS.impl("flash_combine", _combine_cuda, "CUDA")


@torch.library.register_fake("repro_torch::flash_partial", lib=_OPS)
def _partial_fake(q, k, v, lens, len_all, m, l, acc, block_s, path):
    return None


@torch.library.register_fake("repro_torch::flash_combine", lib=_OPS)
def _combine_fake(m, l, acc, mc, lc, ac, out, normalise, path):
    return None


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_partial)
    def _partial_flops(q, k, *args, out_val=None, **kwargs):
        B, H, d = q
        return 4 * B * H * k[1] * d

    @register_flop_formula(torch.ops.repro_torch.flash_combine)
    def _combine_flops(m, l, acc, mc, lc, ac, *args, out_val=None,
                       **kwargs):
        n = 0 if acc is None else acc[2]
        B, H, d = ac if ac is not None else (acc[0], acc[1], acc[3])
        return 2 * B * H * (n + (ac is not None)) * d


_register_flops()


def flash_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length: Length, *, block_s: int = 512,
                  out: Optional[Partials] = None,
                  path: Optional[str] = None) -> Partials:
    """The partial pass: per split of ``block_s`` positions, ``(m, l, acc)``.

    q (B, H, d); k, v (B, S, Hkv, d) with unit stride on d and any strides
    on b, s and the kv head; length (B,) valid positions (a tensor, or an
    int for every row).  ``out`` receives the partials (see
    :func:`empty_partials`); new tensors if None.  A launch is counted in
    ``launches`` and, given ``path``, in ``launches_by_path[path]``.
    """
    B, H, d, S, hkv, G = _check(q, k, v, block_s)
    n = nsplits(S, block_s)
    if q.device.type == "cpu":
        res = flash_partial_plain(q, k, v, length, block_s=block_s)
        if out is None:
            return res
        _check_partials(out, B, H, n, d, q.device)
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_partial runs on cpu or cuda, not {q.device}")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("k and v need unit stride on head_dim")
    if B > 65535 or n * hkv >= 2**31:
        raise ValueError(f"grid too large: B={B}, Hkv={hkv}, splits={n}")
    if out is None:
        out = empty_partials(B, H, n, d, q.device)
    _check_partials(out, B, H, n, d, q.device)
    qf = q.to(torch.float32).contiguous()
    if isinstance(length, torch.Tensor):
        lens = length.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.numel() != B:
            raise ValueError(f"length has {lens.numel()} rows, q has {B}")
        len_all = 0
    else:
        lens, len_all = None, int(length)
    torch.ops.repro_torch.flash_partial(qf, k, v, lens, len_all, *out,
                                        block_s, path or "")
    return out


def flash_combine(partials: Optional[Partials], *,
                  carry: Optional[Partials] = None, normalise: bool = False,
                  out: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32,
                  path: Optional[str] = None):
    """The combine pass over ``partials`` (m, l (B, H, n); acc (B, H, n, d);
    None for no split), starting from ``carry`` (m, l (B, H); acc
    (B, H, d)) when given.

    ``normalise=False``: the fold is written back into ``carry`` in place
    (it must be given), which is returned.  ``normalise=True``: returns
    ``acc / max(l, 1e-20)`` as (B, H, d) in ``out_dtype`` (into ``out`` when
    given, unit stride on d); the carry is only read.  A launch is counted
    as :func:`flash_partial`'s is.
    """
    ref = carry[0] if carry is not None else \
        (partials[0] if partials is not None else None)
    if ref is None:
        raise ValueError("nothing to combine: no partials and no carry")
    if not normalise and carry is None:
        raise ValueError("the combine pass writes back into a carry; pass "
                         "carry= or normalise=True")
    dev = ref.device
    B, H = ref.shape[:2]
    d = (carry[2] if carry is not None else partials[2]).shape[-1]
    n = 0 if partials is None else partials[0].shape[-1]
    if partials is not None:
        _check_partials(partials, B, H, n, d, dev)
    if carry is not None:
        _check_partials(tuple(t.unsqueeze(2) for t in carry), B, H, 1, d, dev)
    if out is not None:
        out_dtype = out.dtype
        if tuple(out.shape) != (B, H, d) or out.device != dev \
                or out.stride(2) != 1:
            raise ValueError(f"out must be ({B}, {H}, {d}) on {dev} with unit "
                             f"stride on d, got {tuple(out.shape)}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out dtype must be float32, bfloat16 or float16, "
                        f"got {out_dtype}")
    if dev.type == "cpu":
        res = flash_combine_plain(partials, carry=carry, normalise=normalise,
                                  out_dtype=out_dtype)
        if normalise:
            if out is None:
                return res
            out.copy_(res)
            return out
        for c, r in zip(carry, res):
            c.copy_(r)
        return carry
    if dev.type != "cuda":
        raise ValueError(f"flash_combine runs on cpu or cuda, not {dev}")
    if normalise and out is None:
        out = torch.empty((B, H, d), dtype=out_dtype, device=dev)
    torch.ops.repro_torch.flash_combine(
        *(partials or (None,) * 3), *(carry or (None,) * 3),
        out if normalise else None, normalise, path or "")
    return out if normalise else carry


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: Length, *, block_s: int = 512
                           ) -> torch.Tensor:
    """Single-token GQA attention against a KV cache.

    q: (B, H, d); k, v: (B, S, Hkv, d); length: (B,) valid positions
    (positions >= length are masked).  Returns (B, H, d) in q's dtype: the
    partial pass over splits of ``block_s`` positions, then the combine
    pass in normalise mode.
    """
    return flash_combine(flash_partial(q, k, v, length, block_s=block_s),
                         normalise=True, out_dtype=q.dtype)


flash_partial.launches = 0
flash_combine.launches = 0
flash_partial.launches_by_path = {}
flash_combine.launches_by_path = {}

"""fe25519 in PyTorch: batched arithmetic mod p = 2^255 - 19.

Same representation as the JAX package (``cudabulletproof_tpu/ops/field.py``):
a batch of field elements is an int32 tensor ``[..., 20]`` of 13-bit limbs,
little-endian, kept *weakly normalized* (every limb in ``[0, BOUND]`` with
``BOUND = 8799``; the value may be >= p).  ``to_bytes`` / ``canonical`` reduce
fully.  Every partial product of the 20x20 limb convolution is below
``20 * 8799^2 < 2^31``, so all arithmetic is exact in int32.

Dispatch: ``mul``, ``sq``, ``mul_chain``, ``pow2523``, ``invert``, ``add3``
and ``sub3`` run their hand-written CUDA kernel (``ops/cuda_field.py``) on a
CUDA tensor and their plain torch twin (``mul_plain``, ``sq_plain``,
``mul_chain_plain``, ``pow2523_plain``, ``invert_plain``, ``add3_plain``,
``sub3_plain``) on a CPU tensor.  The twins compute the same limbs as the kernels and as the JAX
package's ``mul_xla`` / Pallas ``_conv_fold`` (20x20 convolution, fold x608,
three relax passes), so kernel, twin and reference agree limb for limb.
``add3`` / ``sub3`` are the Pallas ``PF.add`` / ``PF.sub`` (three relax
passes), which only the CLI's field microbenchmark calls; ``add`` / ``sub``
are the JAX package's plain ``F.add`` / ``F.sub`` (two passes), which every
other caller uses, and stay plain torch.  Everything else here is plain
torch on either device, as the JAX package computes it outside any Pallas
kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from . import cuda_field
from .consts import on_device

# --- constants ---------------------------------------------------------------
L = 20                      # number of limbs
W = 13                      # bits per limb
MASK = (1 << W) - 1         # 0x1FFF
P = (1 << 255) - 19         # the field prime
FOLD = 608                  # 2^260 mod p (= 32 * 19)
BOUND = MASK + FOLD         # 8799, the weak-normalization limb bound
DTYPE = torch.int32

# K = 2*(2^260 - 1) - 1214: a multiple of p whose limbs all exceed 2^13, so
# K - b has non-negative limbs for any weakly normalized b.
_K_NEG = np.full((L,), 2 * MASK, dtype=np.int32)
_K_NEG[0] = 2 * MASK - 1214
assert sum(int(v) << (W * i) for i, v in enumerate(_K_NEG)) % P == 0

_ROLL_MULT = np.ones((L,), dtype=np.int32)
_ROLL_MULT[0] = FOLD


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


# --- construction and host conversion ----------------------------------------
def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (L,), dtype=DTYPE, device=device)


def ones(shape=(), device="cpu") -> torch.Tensor:
    out = zeros(shape, device)
    out[..., 0] = 1
    return out


def _int_limbs(x: int) -> list:
    x %= P
    return [(x >> (W * i)) & MASK for i in range(L)]


def from_int(x: int, shape=(), device="cpu") -> torch.Tensor:
    """Python int (mod p) -> limbs broadcast to `shape`."""
    arr = torch.tensor(_int_limbs(x), dtype=DTYPE, device=device)
    return arr.expand(tuple(shape) + (L,))


def from_ints(xs, device="cpu") -> torch.Tensor:
    """List of python ints -> [n, 20] limbs (reduced mod p)."""
    out = np.array([_int_limbs(x) for x in xs], dtype=np.int32).reshape(-1, L)
    return torch.from_numpy(out).to(device)


def to_ints(a: torch.Tensor) -> list:
    """[n, 20] limbs -> list of python ints (NOT reduced mod p)."""
    arr = a.detach().cpu().numpy().reshape(-1, L)
    return [sum(int(v) << (W * i) for i, v in enumerate(row)) for row in arr]


# --- normalization -----------------------------------------------------------
def _relax(t: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry relaxation: t <- (t & MASK) + roll(t >> 13), the carry
    out of limb 19 re-entering limb 0 times 608.  Value preserved mod p."""
    m = on_device(_ROLL_MULT, t.device)
    for _ in range(passes):
        t = (t & MASK) + torch.roll(t >> W, 1, dims=-1) * m
    return t


def _carry_pass(t: torch.Tensor) -> torch.Tensor:
    """One sequential carry pass (canonicalization only): limbs < 2^13."""
    limbs = t.unbind(-1)
    out = []
    c = torch.zeros_like(limbs[0])
    for i in range(L):
        v = limbs[i] + c
        out.append(v & MASK)
        c = v >> W
    out[0] = out[0] + c * FOLD
    return torch.stack(out, dim=-1)


def normalize_weak(t: torch.Tensor) -> torch.Tensor:
    """Non-negative limbs < 2^31 -> the weak invariant (3 passes, the count
    proved by the JAX package's tests/test_bounds.py)."""
    return _relax(t, 3)


# --- ring ops ----------------------------------------------------------------
def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _relax(a + b, 2)


def neg(b: torch.Tensor) -> torch.Tensor:
    return _relax(on_device(_K_NEG, b.device) - b, 2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _relax(a + (on_device(_K_NEG, b.device) - b), 2)


def add3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fe_add kernel: a + b, three relax passes."""
    return _relax(a + b, 3)


def sub3_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fe_sub kernel: a + (K - b), three relax passes."""
    return _relax(a + (on_device(_K_NEG, b.device) - b), 3)


def add3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p as the Pallas ``_add_kernel`` computes it (three relax
    passes); batch dims broadcast."""
    if _on_cpu(a, b):
        return add3_plain(a, b)
    return cuda_field.add(a, b)


def sub3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p as the Pallas ``_sub_kernel`` computes it."""
    if _on_cpu(a, b):
        return sub3_plain(a, b)
    return cuda_field.sub(a, b)


def limb_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb convolution [..., m] x [..., k] -> [..., m+k-1], broadcasting the
    batch dims: coefficient s is sum over i+j=s of a_i * b_j.

    The m*k products are laid out as an [m, k] matrix, each row i shifted
    right by i (pad to width k+m and re-read the flat buffer with row stride
    k+m-1), and summed over rows.  The coefficients are exact integers, so
    they equal a shift-and-add convolution's whatever the summation order
    (callers keep them below 2^31)."""
    m, k = a.shape[-1], b.shape[-1]
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)             # [..., m, k]
    batch = prod.shape[:-2]
    skew = tnf.pad(prod, (0, m)).reshape(*batch, m * (k + m))
    skew = skew[..., : m * (k + m - 1)].reshape(*batch, m, k + m - 1)
    return skew.sum(dim=-2, dtype=DTYPE)


def _fold_relax(acc: torch.Tensor) -> torch.Tensor:
    """[..., 39] coefficients -> [..., 20] weak limbs: coefficient 20+j folds
    x608 into limb j (its low 13 bits) and limb j+1 (the rest), then three
    relax passes (mul_xla :189-193 of the JAX package)."""
    top = acc[..., L:]
    main = acc[..., :L]
    main = main + tnf.pad(FOLD * (top & MASK), (0, 1))
    main = main + tnf.pad(FOLD * (top >> W), (1, 0))
    return _relax(main, 3)


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fe_mul kernel: a*b mod p, weak limbs."""
    return _fold_relax(limb_conv(a, b))


def sq_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fe_sq kernel.  The kernel sums the symmetric
    convolution (210 products); the coefficients, hence the limbs, are the
    same as the full product's."""
    return _fold_relax(limb_conv(a, a))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod p; batch dims broadcast."""
    if _on_cpu(a, b):
        return mul_plain(a, b)
    return cuda_field.mul(a, b)


def sq(a: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a):
        return sq_plain(a)
    return cuda_field.sq(a)


def mul_chain_plain(a: torch.Tensor, b: torch.Tensor,
                    reps: int) -> torch.Tensor:
    """Plain twin of the fe_mul_chain kernel: x <- mul_plain(x, b), `reps`
    times from x = a (reps <= 0 gives a)."""
    x = torch.broadcast_tensors(a, b)[0].clone()
    for _ in range(reps):
        x = mul_plain(x, b)
    return x


def mul_chain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """`reps` dependent multiplies x <- x*b from x = a, one kernel launch on
    the card: the radix-13 side of the radix-16 A/B (the JAX package's
    ``benchmarks/bench_radix16.py::chain13``)."""
    if _on_cpu(a, b):
        return mul_chain_plain(a, b, reps)
    return cuda_field.mul_chain(a, b, reps)


def _sqn(a, n: int, sq_fn):
    for _ in range(n):
        a = sq_fn(a)
    return a


def _pow_chain_250(z, sq_fn, mul_fn):
    """Shared prefix of the Fermat ladders: (z^(2^250-1), z^11)."""
    z2 = sq_fn(z)
    z8 = _sqn(z2, 2, sq_fn)
    z9 = mul_fn(z, z8)
    z11 = mul_fn(z2, z9)
    z22 = sq_fn(z11)
    z_5_0 = mul_fn(z9, z22)                                  # 2^5 - 1
    z_10_0 = mul_fn(_sqn(z_5_0, 5, sq_fn), z_5_0)            # 2^10 - 1
    z_20_0 = mul_fn(_sqn(z_10_0, 10, sq_fn), z_10_0)         # 2^20 - 1
    z_40_0 = mul_fn(_sqn(z_20_0, 20, sq_fn), z_20_0)         # 2^40 - 1
    z_50_0 = mul_fn(_sqn(z_40_0, 10, sq_fn), z_10_0)         # 2^50 - 1
    z_100_0 = mul_fn(_sqn(z_50_0, 50, sq_fn), z_50_0)        # 2^100 - 1
    z_200_0 = mul_fn(_sqn(z_100_0, 100, sq_fn), z_100_0)     # 2^200 - 1
    z_250_0 = mul_fn(_sqn(z_200_0, 50, sq_fn), z_50_0)       # 2^250 - 1
    return z_250_0, z11


def pow2523_plain(z: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fe_pow2523 kernel: z^(2^252 - 3)."""
    z_250_0, _ = _pow_chain_250(z, sq_plain, mul_plain)
    return mul_plain(_sqn(z_250_0, 2, sq_plain), z)


def pow2523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8), the square-root step of point decompression."""
    if _on_cpu(z):
        return pow2523_plain(z)
    return cuda_field.pow2523(z)


def invert_plain(z: torch.Tensor) -> torch.Tensor:
    """Plain twin of the fe_invert kernel: z^(p-2) = z^(2^255 - 21), the
    complete Fermat chain (zero maps to zero)."""
    z_250_0, z11 = _pow_chain_250(z, sq_plain, mul_plain)
    return mul_plain(_sqn(z_250_0, 5, sq_plain), z11)


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2): 1/z for z != 0 mod p."""
    if _on_cpu(z):
        return invert_plain(z)
    return cuda_field.invert(z)


def _prefix_products(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along dim 0 in ceil(log2 n) rounds (a
    Hillis-Steele scan): round d multiplies row i by row i - d for every
    i >= d, one batched ``mul`` (one fe_mul launch on the card)."""
    d = 1
    while d < a.shape[0]:
        a = torch.cat([a[:d], mul(a[:-d], a[d:])])
        d *= 2
    return a


def batch_invert(a: torch.Tensor) -> torch.Tensor:
    """Invert nonzero field elements a [n, ..., 20] along dim 0 with ONE
    Fermat inversion (Montgomery's trick): 1/a_i = (a_0 ... a_{i-1}) *
    (a_{i+1} ... a_{n-1}) / (a_0 ... a_{n-1}).  The JAX package's
    ``field.batch_invert`` with its ``associative_scan`` replaced by
    ``_prefix_products``; the products are taken in another order, so the
    limbs differ and the values agree."""
    n = a.shape[0]
    prefix = _prefix_products(a)
    total_inv = invert(prefix[-1])
    suffix = _prefix_products(a.flip(0)).flip(0)
    one = ones(a.shape[1:-1], a.device)[None]
    pre = torch.cat([one, prefix[:n - 1]])
    suf = torch.cat([suffix[1:], one])
    return mul(mul(pre, suf), total_inv[None])


def cswap(swap: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Branchless conditional swap."""
    m = (-swap.to(DTYPE)).unsqueeze(-1)
    diff = (a ^ b) & m
    return a ^ diff, b ^ diff


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small constant 0 <= c < 2^17 (limb products < 2^31)."""
    if not 0 <= c < (1 << 17):
        raise ValueError(f"mul_small constant out of range: {c}")
    return normalize_weak(a * c)


# --- canonical form and serialization ----------------------------------------
def _with_limb(a: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    a = a.clone()
    a[..., i] = v
    return a


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce weak limbs to [0, p), still in limb form."""
    for _ in range(2):     # fold bits >= 255 (2^255 == 19), twice
        t = a[..., L - 1] >> 8
        a = _with_limb(a, L - 1, a[..., L - 1] & 0xFF)
        a = _carry_pass(_with_limb(a, 0, a[..., 0] + 19 * t))
    # conditional subtract p:  v >= p  <=>  v + 19 >= 2^255
    u = _carry_pass(_with_limb(a, 0, a[..., 0] + 19))
    ge_p = ((u[..., L - 1] >> 8) & 1).bool()
    u = _with_limb(u, L - 1, u[..., L - 1] & 0xFF)
    return torch.where(ge_p.unsqueeze(-1), u, a)


# byte j of the encoding = bits 8j..8j+7: limb i0 = 8j // 13 shifted right by
# off = 8j % 13, OR'd with limb i0+1 shifted left by 13 - off.
_TB_I0 = np.array([(8 * j) // W for j in range(32)], dtype=np.int64)
_TB_OFF = np.array([(8 * j) % W for j in range(32)], dtype=np.int32)
_TB_I1 = _TB_I0 + 1
_TB_SHL = (W - _TB_OFF).astype(np.int32)
# limb i = bits 13i..13i+12: bytes j0 = 13i // 8, j0+1, j0+2 from off = 13i % 8
_FB_J0 = np.array([(W * i) // 8 for i in range(L)], dtype=np.int64)
_FB_OFF = np.array([(W * i) % 8 for i in range(L)], dtype=np.int32)
_FB_J1 = _FB_J0 + 1
_FB_J2 = _FB_J0 + 2
_FB_SH1 = (8 - _FB_OFF).astype(np.int32)
_FB_SH2 = (16 - _FB_OFF).astype(np.int32)


def to_bytes(a: torch.Tensor) -> torch.Tensor:
    """Canonical 32-byte little-endian encoding, uint8 [..., 32]."""
    dev = a.device
    ap = tnf.pad(canonical(a), (0, 1))
    v = (ap[..., on_device(_TB_I0, dev)] >> on_device(_TB_OFF, dev)) | (
        ap[..., on_device(_TB_I1, dev)] << on_device(_TB_SHL, dev))
    return (v & 0xFF).to(torch.uint8)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """32-byte LE [..., 32] -> limbs < 2^13 (all 256 bits kept)."""
    dev = b.device
    bp = tnf.pad(b.to(DTYPE), (0, 2))
    v = ((bp[..., on_device(_FB_J0, dev)] >> on_device(_FB_OFF, dev))
         | (bp[..., on_device(_FB_J1, dev)] << on_device(_FB_SH1, dev))
         | (bp[..., on_device(_FB_J2, dev)] << on_device(_FB_SH2, dev)))
    return v & MASK


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact equality mod p -> bool over batch dims."""
    return torch.all(canonical(a) == canonical(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


# --- inner products (pallas_field.inner_product / inner_product_batched) ----
IP_LANES = cuda_field.IP_LANES      # elements a tile
IP_COLUMNS = cuda_field.IP_COLUMNS  # partial columns; tile t adds into t % 128
IP_MAX = 1 << 17             # the column sums stay below 2^31 up to here
_IP_CHUNK_TILES = 32         # tiles a step of the twin (bounds its memory)


def _ip_operands(a: torch.Tensor, b: torch.Tensor):
    """Check [B, n, 20] x [B, n, 20] with n <= IP_MAX; returns n."""
    if a.shape != b.shape or a.dim() != 3 or a.shape[-1] != L:
        raise ValueError(f"inner product of {tuple(a.shape)} and "
                         f"{tuple(b.shape)}: needs two [B, n, {L}]")
    n = a.shape[1]
    if n > IP_MAX:
        raise ValueError(f"inner product of {n} elements: at most {IP_MAX} "
                         "keep the int32 column sums exact")
    return n


def ip_partial_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The twins' first step: [B, n, 20] x [B, n, 20] -> the Pallas
    kernels' partial [B, 39, 256].  Elements are zero-padded
    to tiles of 256; for each element the 39 convolution coefficients are
    split into lo = c & MASK and hi = c >> 13, each summed over its tile;
    tile t adds its lo sums into column t % 128 and its hi sums into column
    128 + t % 128.  Integer sums, so the order does not change the limbs."""
    n = _ip_operands(a, b)
    B = a.shape[0]
    nt = max(1, -(-n // IP_LANES))
    cols = -(-nt // IP_COLUMNS) * IP_COLUMNS
    pad = cols * IP_LANES - n
    a = tnf.pad(a, (0, 0, 0, pad)).reshape(B, cols, IP_LANES, L)
    b = tnf.pad(b, (0, 0, 0, pad)).reshape(B, cols, IP_LANES, L)
    lo = torch.zeros((B, cols, 2 * L - 1), dtype=DTYPE, device=a.device)
    hi = torch.zeros_like(lo)
    for t in range(0, nt, _IP_CHUNK_TILES):
        c = limb_conv(a[:, t:t + _IP_CHUNK_TILES],
                      b[:, t:t + _IP_CHUNK_TILES])    # [B, tiles, 256, 39]
        lo[:, t:t + _IP_CHUNK_TILES] = (c & MASK).sum(dim=2, dtype=DTYPE)
        hi[:, t:t + _IP_CHUNK_TILES] = (c >> W).sum(dim=2, dtype=DTYPE)
    lo = lo.reshape(B, -1, IP_COLUMNS, 2 * L - 1).sum(dim=1, dtype=DTYPE)
    hi = hi.reshape(B, -1, IP_COLUMNS, 2 * L - 1).sum(dim=1, dtype=DTYPE)
    return torch.cat([lo, hi], dim=1).transpose(1, 2).contiguous()


def fold_wide(acc: torch.Tensor) -> torch.Tensor:
    """[..., m] coefficients -> [..., 20], the JAX package's ``_fold_wide``
    (pallas_field.py:88): while more than 20 remain, coefficient 20+j folds
    x608 into j (its low 13 bits) and j+1 (the rest); 41 coefficients take
    two rounds (41 -> 22 -> 20).  No relaxation."""
    while acc.shape[-1] > L:
        main, top = acc[..., :L], acc[..., L:]
        k = top.shape[-1]
        wn = max(L, k + 1)
        acc = (tnf.pad(main, (0, wn - L))
               + tnf.pad(FOLD * (top & MASK), (0, wn - k))
               + tnf.pad(FOLD * (top >> W), (1, wn - k - 1)))
    return acc


def ip_combine(partial: torch.Tensor) -> torch.Tensor:
    """The partial [B, 39, 256] -> [B, 20] weak limbs, the glue of the JAX
    package's ``inner_product`` (pallas_field.py:315-326): the lo columns
    summed at their coefficient, each hi column split again, its low 13
    bits one limb up and the rest two up, into 41 coefficients; then
    ``fold_wide`` and ``normalize_weak``."""
    s0 = partial[..., :IP_COLUMNS].sum(dim=-1, dtype=DTYPE)
    s_hi = partial[..., IP_COLUMNS:]
    h0 = (s_hi & MASK).sum(dim=-1, dtype=DTYPE)
    h1 = (s_hi >> W).sum(dim=-1, dtype=DTYPE)
    t = tnf.pad(s0, (0, 2)) + tnf.pad(h0, (1, 1)) + tnf.pad(h1, (2, 0))
    return normalize_weak(fold_wide(t))


def inner_product_batched_plain(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``inner_product_batched`` (the fe_inner_product
    kernels): [B, n, 20] -> [B, 20]."""
    return ip_combine(ip_partial_plain(a, b))


def inner_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``inner_product``: [n, 20] x [n, 20] -> [20]."""
    return inner_product_batched_plain(a[None], b[None])[0]


def inner_product_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B inner products <a_i, b_i> mod p: [B, n, 20] x [B, n, 20] -> [B, 20]
    weak limbs, the JAX package's ``pallas_field.inner_product_batched``
    limb for limb.  n <= 2^17 (ValueError above)."""
    if _on_cpu(a, b):
        return inner_product_batched_plain(a, b)
    _ip_operands(a, b)
    return cuda_field.inner_product(a, b, batched=True)


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> mod p: [n, 20] x [n, 20] -> [20] weak limbs, the JAX
    package's ``pallas_field.inner_product`` limb for limb.  n <= 2^17."""
    if _on_cpu(a, b):
        return inner_product_plain(a, b)
    _ip_operands(a[None], b[None])
    return cuda_field.inner_product(a[None], b[None], batched=False)[0]

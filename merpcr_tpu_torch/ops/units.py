"""Helpers of the plain PyTorch kernel versions (the counterparts of
``csrc/units.cuh``, ``csrc/compact.cuh`` and ``csrc/records.cuh``) and of
the wrappers' argument checks.

PyTorch's CPU build has no shifts on ``torch.uint32`` and its ``int32``
right shift sign-extends, so the plain versions hold every 32-bit word in
an int64 tensor and mask with ``M32`` after each left shift or multiply;
the results equal the kernels' ``uint32_t`` arithmetic bit for bit.
"""

from __future__ import annotations

import torch

from .encoding import AMBIG, iupac_exp_masks

M32 = 0xFFFFFFFF
# IUPAC expansion masks of the 16 genome letters (csrc/records.cuh kExpNib)
EXP_NIB = tuple(int(v) for v in iupac_exp_masks()[0])


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 words (uint32 bit patterns) -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def units_of(plane: torch.Tensor) -> torch.Tensor:
    """uint8 plane -> its little-endian uint32 units (as int64)."""
    b = plane.to(torch.int64).view(-1, 4)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def codes_of(u: torch.Tensor) -> torch.Tensor:
    """The 8 low 2-bit fields of a unit's nibbles, packed into 16 bits."""
    m = u & 0x33333333
    m = (m | (m >> 2)) & 0x0F0F0F0F
    m = (m | (m >> 4)) & 0x00FF00FF
    return (m | (m >> 8)) & 0xFFFF


def dirty_of(u: torch.Tensor) -> torch.Tensor:
    """Per-base 2-bit field, nonzero iff the base's nibble is >= 4."""
    return codes_of(u >> 2)


def unit_regs(units: torch.Tensor, r: torch.Tensor):
    """(A, Aa, B, Ba) registers of the 24-base windows at units ``r``:
    A = bases 0..15, B = bases 16..23, with their dirty fields."""
    u0, u1, u2 = units[r], units[r + 1], units[r + 2]
    A = codes_of(u0) | (codes_of(u1) << 16)
    Aa = dirty_of(u0) | (dirty_of(u1) << 16)
    return A, Aa, codes_of(u2), dirty_of(u2)


def group_regs(units: torch.Tensor, q: torch.Tensor, lead_units: int,
               stride: int = 4):
    """(A, Aa, B, Ba) registers of stride groups ``q``: a unit holds
    P = 8 / stride groups, and group q = P * r + p starts at base
    stride * p of unit r, so its registers are the unit's shifted right by
    that many bases (``scan.py:581-588``, ``:783-795``)."""
    per_unit = 8 // stride
    A, Aa, B, Ba = unit_regs(units, q // per_unit + lead_units)
    sh = 2 * stride * (q % per_unit)  # 0 keeps the unit's own registers
    return (((A >> sh) | (B << (32 - sh))) & M32,
            ((Aa >> sh) | (Ba << (32 - sh))) & M32, B >> sh, Ba >> sh)


def mask_bases(n: int) -> int:
    """Mask of the low ``n`` bases (2 bits each) of a 32-bit register; 16
    bases fill it."""
    return (1 << (2 * min(n, 16))) - 1


def valid_phases(Aa, Ba, pos0, n_phases: int, W: int, n_scan: int):
    """Bit d set iff bases d..d+W-1 of the window (dirty fields Aa, Ba)
    are clean and scan position pos0 + d is in bounds (``nbv``,
    ``scan.py:796-802``)."""
    d = torch.arange(n_phases, device=Aa.device)
    # bases d .. d+W-1 (the spill from B is masked off where it is unused)
    pha = ((Aa[:, None] >> (2 * d)) | (Ba[:, None] << (32 - 2 * d))) & mask_bases(W)
    ok = (pha == 0) & (pos0[:, None] + d < n_scan)
    return (ok.to(torch.int64) << d).sum(dim=1)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a, c in [0, 2^32), without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def nibbles_at(plane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """4-bit codes at plane positions ``pos`` (low nibble = even position);
    positions outside the plane read 0xFF, which equals no primer code."""
    n_pos = 2 * plane.numel()
    inside = (pos >= 0) & (pos < n_pos)
    p = pos.clamp(0, n_pos - 1)
    b = plane[p >> 1].to(torch.int64)
    nib = torch.where((p & 1) == 1, b >> 4, b & 15)
    return torch.where(inside, nib, torch.full_like(nib, 0xFF))


def scode(b: torch.Tensor) -> torch.Tensor:
    """2-bit hash codes of bytes ``b`` (int64 values 0..255): A/a 0, C/c 1,
    G/g 2, T/t/U/u 3, every other byte AMBIG (``encoding.SCODE``, computed
    as the JAX package's ``_encode_codes`` computes it, ``scan.py:270-284``;
    csrc/units.cuh ``mp::scode``)."""
    folded = b | 32  # lowercase letters unchanged; uppercase -> lowercase
    is_letter = (folded >= ord("a")) & (folded <= ord("z"))
    b5 = b & 0x1F
    code = torch.full_like(b, AMBIG)
    for low5, c in ((1, 0), (3, 1), (7, 2), (20, 3), (21, 3)):
        code = torch.where(b5 == low5, c, code)
    return torch.where(is_letter, code, AMBIG)


def fold(b: torch.Tensor) -> torch.Tensor:
    """ASCII a..z -> A..Z; every other value unchanged (``_byte_fold``,
    ``scan.py:263-267``; csrc/records.cuh ``mp::fold``)."""
    return torch.where((b >= ord("a")) & (b <= ord("z")), b - 32, b)


def raw_hashes(plane: torch.Tensor, pos: torch.Tensor, W: int):
    """(h, amb) of the W-byte windows that start at plane positions ``pos``
    of a byte plane: the LSB-first 2-bit W-mer h (base k at bits 2k, 2k+1;
    at W = 16 all 32 bits, held in int64) and whether a byte of the window
    is AMBIG (``scan.py:661-669``)."""
    codes = scode(plane.to(torch.int64))
    h = torch.zeros_like(pos)
    amb = torch.zeros_like(pos, dtype=torch.bool)
    for k in range(W):
        c = codes[pos + k]
        amb |= c == AMBIG
        h |= torch.where(c == AMBIG, 0, c) << (2 * k)
    return h, amb


def bytes_at(plane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bytes of a byte plane at positions ``pos`` (int64); positions outside
    the plane read -1, which equals no byte (0xFF is a real byte, ÿ)."""
    n_pos = plane.numel()
    inside = (pos >= 0) & (pos < n_pos)
    b = plane[pos.clamp(0, n_pos - 1)].to(torch.int64)
    return torch.where(inside, b, -1)


def byte_matches(s: torch.Tensor, e: torch.Tensor, primer_bytes, match):
    """Genome bytes ``s`` [n, P] (-1 outside the plane) against primer row
    ``e`` [n] (or [n, 1]) of ``primer_bytes``: case-insensitive equality
    (``match`` None, -I 0, ``scan.py:1031``), else the reference's 256 x 256
    table ``match[s * 256 + p] != 0`` (-I 1, ``:1029``). -1 matches
    nothing."""
    p = primer_bytes.to(torch.int64)[e]
    if match is None:
        return (s >= 0) & (fold(s) == fold(p))
    m = match.to(torch.int64)[(s.clamp(min=0) * 256 + p)]
    return (s >= 0) & (m != 0)


def records_at(rmeta: torch.Tensor, recmap, gpos: torch.Tensor):
    """(record id, start, length) of the record owning plane positions
    ``gpos`` (``scan.py:993-1005``): ``recmap`` maps 8-position blocks to
    records; None means the plane holds record 0 alone."""
    if recmap is None:
        rid = torch.zeros_like(gpos)
    else:
        rid = recmap.to(torch.int64)[(gpos >> 3).clamp(0, recmap.numel() - 1)]
    row = rmeta.to(torch.int64)[rid]
    return rid, row[..., 0], row[..., 1]


def base_matches(nib: torch.Tensor, e: torch.Tensor, codes, exp):
    """Genome codes ``nib`` [n, P] against primer row ``e`` [n] (or
    [n, 1]): code equality (``exp`` None, -I 0), else the IUPAC
    expansion-set test ``EXP_NIB[nib] & exp[e] != 0``. Codes outside the
    plane (0xFF) match nothing."""
    if exp is None:
        return nib == codes.to(torch.int64)[e]
    table = torch.tensor(EXP_NIB, dtype=torch.int64, device=nib.device)
    m = torch.where(nib < 16, table[nib.clamp(max=15)], 0)
    return (m & exp.to(torch.int64)[e]) != 0


def record_args(rmeta: torch.Tensor, recmap) -> tuple:
    """(rmeta, recmap, n_map) as the kernels' C arguments."""
    if recmap is None:
        return rmeta.data_ptr(), None, 0
    return rmeta.data_ptr(), recmap.data_ptr(), recmap.numel()


def check_records(rmeta: torch.Tensor, recmap) -> None:
    require(rmeta, torch.int32, "rmeta")
    if rmeta.dim() != 2 or rmeta.shape[1] != 2 or not rmeta.shape[0]:
        raise ValueError(f"rmeta must be [R, 2], got {tuple(rmeta.shape)}")
    if recmap is not None:
        require(recmap, torch.int32, "recmap")
        if recmap.dim() != 1 or not recmap.numel():
            raise ValueError("recmap must be a non-empty vector")


def check_codes(codes: torch.Tensor, exp, name: str) -> None:
    require(codes, torch.uint8, f"{name}_codes")
    if exp is not None:
        require(exp, torch.int32, f"{name}_exp")
        if exp.shape != codes.shape:
            raise ValueError(f"{name}_exp {tuple(exp.shape)} does not match "
                             f"{name}_codes {tuple(codes.shape)}")


def check_match(match) -> None:
    """``match`` is None (-I 0) or the 256 x 256 byte table, flattened."""
    if match is not None:
        require(match, torch.uint8, "match")
        if match.numel() != 1 << 16:
            raise ValueError(f"match table of {match.numel()} bytes, not 65536")


def kernel_route(*tensors: torch.Tensor) -> bool:
    """True when the inputs lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (plain version). Mixed or other devices raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """A kernel argument must have ``dtype`` and be contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

"""DIA SpMV with the optional fused smoother epilogue: kernel wrapper, its
launch plan, and its plain PyTorch version.

    acc[i] = sum_k data[k, i] * x[i + offsets[k]]   (x is 0 outside [0, len(x)))
    y      = acc                                    (rhs is None)
    y      = [x[i + 128*x_row0] +] c * [dinv *] (rhs - acc)

The port of saena_tpu/ops/pallas_dia_spmv.py:_kernel (dia_spmv and
dia_fused_update there). data is (ndiag, n_pad) in f32, bf16 or f64; x,
rhs, dinv and y are at the compute dtype promote(data, f32), so bf16 data
gives f32 vectors and accumulator. len(x) may exceed n_pad: a rectangular
row block reading a halo-extended x, with x_row0 (in 128-row units, as in
the JAX kernel) placing the block's own rows for the x-add.

`dia_spmv` launches the CUDA kernel (csrc/dia_spmv.cu) for tensors on the
card and runs `dia_spmv_plain` for tensors on the CPU; it never falls back
from one to the other. How it launches is a `DiaPlan` from `dia_plan`, a
pure function of (offsets, n_pad, dtype, SM count):

- "l1": the tiled kernel, x read through L1. A lane owns 16 bytes of rows
  of every diagonal, a block W row warps x G diagonal groups, the grid one
  wave where the card holds it;
- "smem": the same, with per-cluster windows of x staged in shared memory
  (the pick for wide f32 stencils, where it measured faster);
- "rows": the first port's kernel (one thread per row, offsets read from
  memory), for up to CHUNK diagonals (one diagonal group, where the tiled
  kernel measured slower), for more than MAX_DIAGS diagonals or data that
  is not 16-byte aligned, and as the reference of the tiled kernel's times.

`DiaMatrix` keeps its plan, so a launch plans nothing; a test forces a
configuration by passing ``plan=dia_plan(..., config=..., groups=...)``.
Launches are recorded in `runtime.launches` ("dia", its routes and shapes).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from saena_tpu_torch.ops import cuda_build
from saena_tpu_torch.ops.chunks import H100_SMS, sm_count
from saena_tpu_torch.runtime import launched

LANES = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

# limits shared with csrc/dia_spmv.cu
MAX_DIAGS = 256       # diagonals the tiled kernel takes by value
MAX_GROUPS = 8        # diagonal groups of a block
MAX_WINDOWS = 32      # staged x windows
MAX_THREADS = 256     # threads of a block
MIN_BLOCKS = 4        # blocks of MAX_THREADS an SM keeps resident (launch bounds)
MAX_BLOCKS_SM = 32    # resident blocks of an SM (Hopper)
SMEM_BLOCK = 48 * 1024          # shared bytes of a block without opt-in
SMEM_SM = 227 * 1024            # shared bytes of an SM
CHUNK = 8             # diagonals whose loads a thread issues together

# plan choices
DIAGS_PER_GROUP = 13  # diagonals a group sums, about (13: 8 groups on 101 diagonals)
WINDOW_SPAN = 256     # widest run of offsets one staged x window covers
CONFIGS = ("l1", "smem", "rows")
_CONFIG_CODE = {"rows": 0, "l1": 1, "smem": 2}
_ADD_X, _ALIGNED = 4, 8


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def dia_spmv_plain(data, x, offsets, rhs=None, dinv=None, c: float = 1.0,
                   add_x: bool = False, x_row0: int = 0):
    """The same function as the kernel, as a sum of shifted slices of a
    zero-padded x (DiaMatrix.matvec_xla and _dia_rect_xla in saena_tpu)."""
    cdt = compute_dtype(data.dtype)
    x = x.to(cdt)
    n_pad, m_pad = data.shape[1], x.shape[0]
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets) + n_pad - m_pad)
    xp = F.pad(x, (lo, hi))
    y = torch.zeros(n_pad, dtype=cdt, device=x.device)
    for k, off in enumerate(offsets):
        y = y + data[k].to(cdt) * xp[lo + off: lo + off + n_pad]
    if rhs is None:
        return y
    z = rhs.to(cdt) - y
    if dinv is not None:
        z = z * dinv.to(cdt)
    if c != 1.0:
        z = z * c
    if add_x:
        z = z + x[LANES * x_row0: LANES * x_row0 + n_pad]
    return z


# ---------------------------------------------------------------------------
# launch plan (pure Python: the CPU tests check it)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DiaPlan:
    """How the kernel covers an (ndiag, n_pad) operator.

    Tiled configurations ("l1", "smem"): a unit is one warp's 32 lanes x
    ``rows_per_lane`` rows; block b takes the units `unit_range(b)` (the
    first units % grid blocks one more), its ``row_warps`` warps of each
    diagonal group
    taking consecutive units round by round; group h sums the diagonals
    [group_ptr[h], group_ptr[h+1]). ``windows`` are the staged x windows
    (lo, length, base) in x elements relative to a round's first row, and
    ``woff[k]`` = base + offsets[k] - lo of diagonal k's window. "rows":
    one thread per row in blocks of 256."""

    config: str
    n_pad: int
    rows_per_lane: int
    groups: int
    row_warps: int
    grid: int
    units: int
    group_ptr: tuple
    offsets: tuple
    woff: tuple = ()
    windows: tuple = ()
    smem_bytes: int = 0
    packed: np.ndarray = dataclasses.field(default=None, repr=False)
    packed_ptr: int = 0       # its address, for the launch

    @property
    def threads(self) -> int:
        return 32 * self.row_warps * self.groups if self.config != "rows" else 256

    @property
    def rounds(self) -> int:
        """Rounds of the block with the most units."""
        if self.config == "rows":
            return 1
        most = -(-self.units // self.grid)
        return -(-most // self.row_warps)

    def unit_range(self, b):
        """(first, end) unit of block(s) b, as the kernel computes them."""
        q, r = divmod(self.units, self.grid)
        lo = b * q + np.minimum(b, r)
        return lo, lo + q + (b < r)

    def lane_rows(self) -> np.ndarray:
        """First row of every (block, round, row warp, lane) that computes
        rows, in the kernel's index arithmetic; each covers rows_per_lane
        rows."""
        if self.config == "rows":
            return np.arange(self.n_pad, dtype=np.int64)
        V, W = self.rows_per_lane, self.row_warps
        ulo, uhi = self.unit_range(np.arange(self.grid, dtype=np.int64))
        r = np.arange(self.rounds, dtype=np.int64)
        u = ulo[:, None, None] + r[None, :, None] * W + np.arange(W)[None, None, :]
        u = u[u < uhi[:, None, None]]
        rows = (u[:, None] * 32 * V + np.arange(32) * V).reshape(-1)
        return rows[rows < self.n_pad]

    def describe(self) -> dict:
        return {"config": self.config, "rows_per_lane": self.rows_per_lane,
                "groups": self.groups, "row_warps": self.row_warps,
                "threads": self.threads, "grid": self.grid, "rounds": self.rounds,
                "windows": len(self.windows), "smem_bytes": self.smem_bytes}


def _rows_plan(offsets, n_pad) -> DiaPlan:
    return DiaPlan("rows", n_pad, 1, 1, 8, max(1, -(-n_pad // 256)), n_pad,
                   (0, len(offsets)), tuple(offsets))


def _windows(offsets, rows: int, V: int, XV: int):
    """Staged x windows of a round of ``rows`` rows: one per run of sorted
    offsets no wider than WINDOW_SPAN. Returns ((lo, length, base), ...)
    and woff per diagonal, in x elements, every lo/length/base a multiple
    of XV (16 bytes)."""
    order = sorted(range(len(offsets)), key=lambda k: offsets[k])
    runs = []
    for k in order:
        if runs and offsets[k] - offsets[runs[-1][0]] <= WINDOW_SPAN:
            runs[-1].append(k)
        else:
            runs.append([k])
    nv = V // XV + 1
    windows, woff, base = [], [0] * len(offsets), 0
    for run in runs:
        lo = (offsets[run[0]] // XV) * XV
        span = offsets[run[-1]] - lo
        length = -(-(rows - V + span + nv * XV) // XV) * XV
        windows.append((lo, length, base))
        for k in run:
            woff[k] = base + offsets[k] - lo
        base += length
    return tuple(windows), tuple(woff)


def dia_plan(offsets, n_pad: int, dtype, sms: int = H100_SMS,
             config: str | None = None, groups: int | None = None,
             row_warps: int | None = None) -> DiaPlan:
    """The launch plan of an (len(offsets), n_pad) operator with ``dtype``
    data on a card of ``sms`` SMs. ``config`` / ``groups`` / ``row_warps``
    force a choice (tests, chip_smoke.py); None lets the plan pick.

    Configuration: the row kernel ("rows") where the tiled one cannot run,
    and for up to CHUNK diagonals unless groups or row warps are forced:
    one group leaves nothing to split, and there the tiled kernel measured
    slower than the row kernel. Else "smem" for a 4-byte x (f32 and bf16
    data) where the windows fit, else "l1". Groups: one for up to CHUNK
    diagonals, else about DIAGS_PER_GROUP diagonals a group, at most
    MAX_GROUPS. Then
    (groups, row warps) are ranked by the rounds of the busiest block, then
    the units of the busiest SM (blocks land round robin), then more groups
    and row warps; the groups fall from that start only while that shortens
    the ranking."""
    offsets = tuple(int(o) for o in offsets)
    nd = len(offsets)
    if config is not None and config not in CONFIGS:
        raise ValueError(f"dia_plan: config {config!r} not in {CONFIGS}")
    isz = torch.empty(0, dtype=dtype).element_size()
    csz = torch.empty(0, dtype=compute_dtype(dtype)).element_size()
    V, XV = 16 // isz, 16 // csz
    big = max((abs(o) for o in offsets), default=0) + n_pad
    if (config == "rows" or not 1 <= nd <= MAX_DIAGS or n_pad < 1 or n_pad % V
            or big >= 2**30):
        if config != "rows" and (groups or row_warps):
            raise ValueError("dia_plan: this operator takes the row kernel only")
        return _rows_plan(offsets, n_pad)
    if groups is not None and not 1 <= groups <= min(MAX_GROUPS, nd):
        raise ValueError(f"dia_plan: {groups} groups for {nd} diagonals")
    if row_warps is not None and 32 * row_warps * (groups or 1) > MAX_THREADS:
        raise ValueError(f"dia_plan: more than {MAX_THREADS} threads")
    if config is None and nd <= CHUNK and not (groups or row_warps):
        return _rows_plan(offsets, n_pad)
    best = None
    if config is None:
        config = "smem" if nd > CHUNK and csz == 4 else "l1"
        if config == "smem":
            best = _search(config, offsets, n_pad, V, XV, csz, sms, groups, row_warps)
            config = "smem" if best is not None else "l1"
    if best is None:
        best = _search(config, offsets, n_pad, V, XV, csz, sms, groups, row_warps)
    if best is None:
        raise ValueError(f"dia_plan: no {config} plan for {nd} diagonals x {n_pad} rows")
    _, G, W, grid, units, windows, woff, smem = best
    gptr = tuple(h * nd // G for h in range(G + 1))
    head = [_CONFIG_CODE[config], G, W, grid, units, nd, len(windows), smem]
    packed = np.array(head + list(gptr) + list(offsets) + list(woff)
                      + [v for w in windows for v in w], dtype=np.int32)
    return DiaPlan(config, n_pad, V, G, W, grid, units, gptr, offsets, woff,
                   windows, smem, packed, packed.ctypes.data)


def _search(config, offsets, n_pad, V, XV, csz, sms, groups, row_warps):
    """The best (key, G, W, grid, units, windows, woff, smem) of a
    tiled configuration, or None when no (G, W) fits."""
    nd = len(offsets)
    units = -(-n_pad // (32 * V))
    g_top = 1 if nd <= CHUNK else min(MAX_GROUPS, -(-nd // DIAGS_PER_GROUP))
    best = None
    for G in ([groups] if groups else range(min(g_top, nd), 0, -1)):
        for W in ([row_warps] if row_warps else (8, 4, 2, 1)):
            threads = 32 * W * G
            if threads > MAX_THREADS:
                continue
            red = -(-(G - 1) * W * 32 * V // XV) * XV
            windows, woff = ((), ())
            if config == "smem":
                windows, woff = _windows(offsets, W * 32 * V, V, XV)
            smem = (red + sum(w[1] for w in windows)) * csz
            if len(windows) > MAX_WINDOWS or smem > SMEM_BLOCK:
                continue
            bps = MAX_THREADS * MIN_BLOCKS // threads
            bps = min(MAX_BLOCKS_SM, bps, SMEM_SM // smem if smem else bps)
            rounds = -(-units // (W * bps * sms))
            grid = -(-units // (W * rounds))
            busiest = -(-grid // sms) * W * rounds
            key = (rounds, busiest, -G, -W)
            if best is None or key < best[0]:
                best = (key, G, W, grid, units, windows, woff, smem)
    return best


@functools.lru_cache(maxsize=256)
def _cached_plan(offsets, n_pad, dtype, sms):
    return dia_plan(offsets, n_pad, dtype, sms)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


@functools.cache
def _kernel_fns():
    lib = cuda_build.load("dia_spmv")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    rows, tiled, empty = lib.saena_dia_apply, lib.saena_dia_tiled, lib.saena_dia_empty
    rows.argtypes = [i, p, p, p, i, i64, i64, p, p, ctypes.c_double, i, i64, p, p]
    tiled.argtypes = [i, p, i, p, p, i64, i64, p, p, ctypes.c_double, i64, p, p]
    empty.argtypes = [p]
    rows.restype = tiled.restype = empty.restype = ctypes.c_int
    return rows, tiled, empty


def empty_launch(device) -> None:
    """Launch an empty kernel on the current stream (the launch floor)."""
    with torch.cuda.device(device):
        rc = _kernel_fns()[2](torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed with CUDA error {rc}")


def dia_spmv(data, x, offsets, rhs=None, dinv=None, c: float = 1.0,
             add_x: bool = False, x_row0: int = 0, offsets_dev=None, plan=None):
    """y as in the module docstring. ``offsets`` is the tuple of diagonal
    offsets; ``offsets_dev`` optionally the same offsets as an int64 tensor
    on the card, ``plan`` the launch plan (formats cache both, so a launch
    copies and plans nothing). A plan made for other offsets, rows or data
    dtype raises, on every device."""
    offsets = tuple(offsets)
    if plan is not None:
        _check_plan(plan, offsets, data)
    if data.device.type == "cpu":
        return dia_spmv_plain(data, x, offsets, rhs, dinv, c, add_x, x_row0)
    if data.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {data.device}")
    return _dia_cuda(data, x, offsets, rhs, dinv, c, add_x, x_row0,
                     offsets_dev, plan)


def _check_plan(plan: DiaPlan, offsets: tuple, data) -> None:
    """Raise unless ``plan`` was made for these offsets, this n_pad and this
    data dtype (the tiled kernel reads its offsets from the plan)."""
    if (plan.n_pad != data.shape[-1]
            or (plan.offsets is not offsets and plan.offsets != offsets)):
        raise ValueError("dia_spmv: the plan is for another operator")
    if plan.config != "rows" and plan.rows_per_lane * data.element_size() != 16:
        raise ValueError(f"dia_spmv: the plan is for another data dtype than "
                         f"{data.dtype}")


def _variant(rhs, dinv, add_x) -> str:
    """The epilogue's use: plain SpMV, residual, Jacobi or Chebyshev."""
    return ("spmv" if rhs is None else "residual" if dinv is None
            else "jacobi" if add_x else "cheb")


def _dia_cuda(data, x, offsets, rhs, dinv, c, add_x, x_row0, offsets_dev, plan):
    dev = data.device
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"dia_spmv: data dtype {data.dtype} not supported "
                        "(float32, bfloat16, float64)")
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("dia_spmv: data must be a contiguous (ndiag, n_pad) tensor")
    ndiag, n_pad = data.shape
    if ndiag != len(offsets) or ndiag == 0:
        raise ValueError(f"dia_spmv: {ndiag} diagonals but {len(offsets)} offsets")
    cdt = compute_dtype(data.dtype)

    def _vec(t, name, size=None):
        if t.device != dev or t.dim() != 1:
            raise ValueError(f"dia_spmv: {name} must be a 1-D tensor on {dev}")
        if size is not None and t.shape[0] != size:
            raise ValueError(f"dia_spmv: {name} has {t.shape[0]} rows, expected {size}")
        return t.to(cdt).contiguous()

    x = _vec(x, "x")
    m_pad = x.shape[0]
    if rhs is not None:
        rhs = _vec(rhs, "rhs", n_pad)
    elif dinv is not None or add_x:
        raise ValueError("dia_spmv: dinv and add_x need rhs")
    if dinv is not None:
        dinv = _vec(dinv, "dinv", n_pad)
    x0 = LANES * int(x_row0)
    if add_x and not (0 <= x0 and x0 + n_pad <= m_pad):
        raise ValueError(f"dia_spmv: x_row0={x_row0} puts the x-add outside x")
    if plan is None:
        plan = _cached_plan(offsets, n_pad, data.dtype, sm_count(dev))
    if plan.config != "rows" and data.data_ptr() % 16:
        plan = _rows_plan(offsets, n_pad)      # data not in 16-byte rows

    y = torch.empty(n_pad, dtype=cdt, device=dev)
    rows_fn, tiled_fn, _ = _kernel_fns()
    rhs_p = None if rhs is None else rhs.data_ptr()
    dinv_p = None if dinv is None else dinv.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.config == "rows":
            if offsets_dev is None:
                offsets_dev = torch.tensor(offsets, dtype=torch.int64, device=dev)
            elif (offsets_dev.device != dev or offsets_dev.dtype != torch.int64
                  or offsets_dev.shape != (ndiag,)):
                raise ValueError("dia_spmv: offsets_dev must be int64 (ndiag,) on "
                                 "the data's device")
            rc = rows_fn(_DTYPE_CODE[data.dtype], data.data_ptr(), x.data_ptr(),
                         offsets_dev.data_ptr(), ndiag, n_pad, m_pad, rhs_p, dinv_p,
                         float(c), int(bool(add_x)), x0, y.data_ptr(), stream)
        else:
            # x, rhs, dinv in whole 16-byte vectors, or scalar loads
            aligned = (x.data_ptr() % 16 == 0 and (m_pad * x.element_size()) % 16 == 0
                       and (rhs_p or 0) % 16 == 0 and (dinv_p or 0) % 16 == 0)
            flags = _ADD_X * bool(add_x) + _ALIGNED * aligned
            rc = tiled_fn(_DTYPE_CODE[data.dtype], plan.packed_ptr, flags,
                          data.data_ptr(), x.data_ptr(), n_pad, m_pad, rhs_p, dinv_p,
                          float(c), x0, y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv: kernel launch failed with CUDA error {rc}")
    # rect: a rectangular block, a shard's over its halo-extended x
    launched("dia", (n_pad, ndiag, _variant(rhs, dinv, add_x)),
             rows=plan.config == "rows", bf16=data.dtype == torch.bfloat16,
             rect=m_pad != n_pad or x0 != 0)
    return y

"""Build a Hierarchy (``load_hierarchy``) or a ShardedHierarchy
(``load_sharded_hierarchy``, below) from plain numpy arrays: the device
state of the JAX package's hierarchy carried across, so both V-cycles can
run on identical operators, diagonals, eigenvalue estimates and coarse
solves.

``arrays`` maps names to numpy arrays; ``meta`` says what they are::

    meta = {"levels": [{"n": 2744, "lvl": 0, "eig_max": 1.98,
                        "A": {"format": "DiaMatrix", "shape": [2744, 2744],
                              "nnz": 18472, "offsets": [-196, ..., 196]},
                        "P": {"format": "EllMatrix", ...}, "R": ...}, ...],
            "coarse": {"kind": "inv" | "lu" | None, "n": 92},
            "scaled": False}

Level ``l`` keeps its arrays under ``L{l}.inv_diag`` and ``L{l}.{A,P,R}.*``:
``data`` for DiaMatrix (``(ndiag, n_pad)``) and DenseMatrix
(``(n_pad, m_pad)``); ``cols``, ``vals``, ``spill_rows``, ``spill_cols``
and ``spill_vals`` for EllMatrix; ``blocks`` and ``bcols`` for BsrMatrix;
``idx`` (int8), ``vals``, ``strip_of``, ``rb_local`` and ``sb_of`` for
StripMatrix, whose spec also names ``perrow``, ``krb``, ``n_rows_pad``,
``n_cols_pad``, ``n_out`` and ``pick_pairs``; ``idx`` (int8), ``vals``,
``strips`` and ``gather_idx`` for Strip8Matrix, whose spec names
``perrow``, ``mode`` ("general" or "interval"), ``n_cols_pad`` and
``n_out``. A structural transfer is ``{"format": "SmoothedP", "Pt": spec,
"A": "level", ...}`` (``SmoothedR`` with ``"PtT"``) with arrays ``wq`` and
``Pt.*`` (``PtT.*``) under its own key; its A is the level's A, stored
once. A smoothers' twin (Options.smooth_dtype) is ``"A_smooth": spec`` with
its arrays under ``L{l}.A_smooth.*`` and its spec naming its ``dtype``
("float32", "bfloat16", ...), at which its values are loaded; it is absent
or None on levels without one. The coarse solve is ``coarse.inv`` and
``coarse.adense`` (kind "inv"), or ``coarse.dense``, the unit-diagonal-padded
coarsest operator, which is factored here (kind "lu"). ``inv_sq_diag`` is
present when ``scaled``.
"""
from __future__ import annotations

import numpy as np
import torch

from saena_tpu_torch.amg.hierarchy import CoarseLU, Hierarchy, Level
from saena_tpu_torch.ops.formats import (
    BsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    index_to_device,
    int8_to_device,
)
from saena_tpu_torch.ops.strip8_spmv import Strip8Matrix
from saena_tpu_torch.ops.strip_spmv import StripMatrix
from saena_tpu_torch.ops.transfers import SmoothedP, SmoothedR
from saena_tpu_torch.runtime import resolve_device, resolve_dtype

_STRIP_META = ("perrow", "krb", "n_rows_pad", "n_cols_pad", "n_out", "pick_pairs")
_STRIP8_META = ("perrow", "mode", "n_cols_pad", "n_out")


def _values(arr, dtype, device) -> torch.Tensor:
    """Host values at ``dtype`` on ``device``; a 2-byte float array (such as
    bf16 from ml_dtypes) goes through f32, which holds it exactly."""
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 2:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, dtype)


def _matrix(arrays, key, spec, dtype, device, level_A=None):
    if spec.get("dtype"):
        dtype = getattr(torch, spec["dtype"])
    val = lambda name: _values(arrays[f"{key}.{name}"], dtype, device)
    idx = lambda name: index_to_device(arrays[f"{key}.{name}"], device)
    lanes = lambda: int8_to_device(arrays[f"{key}.idx"], device)
    fmt = spec["format"]
    common = dict(shape=spec["shape"], nnz=spec["nnz"])
    if fmt == "DiaMatrix":
        return DiaMatrix(val("data"), spec["offsets"], **common)
    if fmt == "EllMatrix":
        return EllMatrix(idx("cols"), val("vals"), idx("spill_rows"),
                         idx("spill_cols"), val("spill_vals"), **common)
    if fmt == "DenseMatrix":
        return DenseMatrix(val("data"), **common)
    if fmt == "BsrMatrix":
        return BsrMatrix(val("blocks"), idx("bcols"), **common)
    if fmt == "StripMatrix":
        return StripMatrix(lanes(), val("vals"), idx("strip_of"),
                           idx("rb_local"), idx("sb_of"), **common,
                           **{k: spec[k] for k in _STRIP_META})
    if fmt == "Strip8Matrix":
        return Strip8Matrix(lanes(), val("vals"), idx("strips"),
                            idx("gather_idx"), **common,
                            **{k: spec[k] for k in _STRIP8_META})
    if fmt in ("SmoothedP", "SmoothedR"):
        if spec.get("A") != "level" or level_A is None:
            raise ValueError(f"{key}: a structural transfer's A must be the level's")
        inner = "Pt" if fmt == "SmoothedP" else "PtT"
        cls = SmoothedP if fmt == "SmoothedP" else SmoothedR
        return cls(_matrix(arrays, f"{key}.{inner}", spec[inner], dtype, device),
                   level_A, val("wq"), **common)
    raise ValueError(f"format {fmt!r} is not ported")


def load_hierarchy(arrays: dict, meta: dict, dtype=None, device=None) -> Hierarchy:
    """The Hierarchy that ``arrays``/``meta`` describe (see the module
    docstring), on ``device`` at ``dtype``."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    vec = lambda name: torch.from_numpy(
        np.ascontiguousarray(arrays[name])).to(device, dtype)
    levels = []
    for l, spec in enumerate(meta["levels"]):
        mats = {"A": _matrix(arrays, f"L{l}.A", spec["A"], dtype, device)}
        for k in ("P", "R"):
            mats[k] = None if spec.get(k) is None else _matrix(
                arrays, f"L{l}.{k}", spec[k], dtype, device, mats["A"])
        if spec.get("A_smooth") is not None:
            mats["A_smooth"] = _matrix(arrays, f"L{l}.A_smooth",
                                       spec["A_smooth"], dtype, device)
        levels.append(Level(A=mats["A"], inv_diag=vec(f"L{l}.inv_diag"),
                            P=mats["P"], R=mats["R"],
                            A_smooth=mats.get("A_smooth"), n=int(spec["n"]),
                            lvl=int(spec["lvl"]), eig_max=spec.get("eig_max")))
    coarse = meta.get("coarse") or {}
    coarse_lu = None
    if coarse.get("kind") == "inv":
        coarse_lu = CoarseLU(lu=None, piv=None, inv=vec("coarse.inv"),
                             adense=vec("coarse.adense"), n=int(coarse["n"]))
    elif coarse.get("kind") == "lu":
        lu, piv = torch.linalg.lu_factor(vec("coarse.dense"))
        coarse_lu = CoarseLU(lu=lu, piv=piv, inv=None, adense=None,
                             n=int(coarse["n"]))
    return Hierarchy(levels=tuple(levels), coarse_lu=coarse_lu,
                     inv_sq_diag=vec("inv_sq_diag") if meta.get("scaled") else None)


_SHARDED_META = {"ShardedStrip8": ("perrow", "mode", "n_cols_pad", "n_out"),
                 "ShardedDia": ("offsets", "n_loc", "lo_pad", "hi_pad", "compress"),
                 "ShardedDense": ("compress",),
                 "ShardedEll": ("reduce_rows",)}


def load_sharded_operator(arrays: dict, key: str, spec, mesh, dtype=None):
    """The sharded operator ``spec`` (as in ``load_sharded_hierarchy``) with
    its arrays under ``key.``; they hold every shard (D, ...), of which
    the mesh's are loaded. None for a spec of None."""
    from saena_tpu_torch.parallel import sharded as S
    from saena_tpu_torch.parallel.halo import plan_on

    if spec is None:
        return None
    dtype = getattr(torch, spec["dtype"]) if spec.get("dtype") else resolve_dtype(dtype)
    arr = lambda name: np.asarray(arrays[f"{key}.{name}"])
    val = lambda name: S._local(mesh, arr(name).astype(np.float64), dtype)
    idx = lambda name: S._local(mesh, arr(name))
    fmt = spec["format"]
    common = dict(shape=tuple(spec["shape"]), nnz=spec["nnz"],
                  **{k: (tuple(spec[k]) if k == "offsets" else spec[k])
                     for k in _SHARDED_META.get(fmt, ())})
    plan = None
    if "plan" in spec:
        p = spec["plan"]
        plan = plan_on(mesh, arr("send_idx"), p["n_local"], p["max_send"],
                       p["mode"], p.get("compress", ""))
    if fmt == "ShardedEll":
        spill = {}
        if f"{key}.spill_rows" in arrays:
            spill = dict(spill_rows=idx("spill_rows"), spill_cols=idx("spill_cols"),
                         spill_vals=val("spill_vals"))
        return S.ShardedEll(idx("cols"), val("vals"), plan, **spill, **common)
    if fmt == "ShardedBsr":
        return S.ShardedBsr(val("blocks"), idx("bcols"), plan, **common)
    if fmt == "ShardedStrip8":
        return S.ShardedStrip8(
            torch.from_numpy(np.array(arr("idx")[mesh.local], dtype=np.int8)
                             ).to(mesh.device),
            val("vals"), S._int32(mesh, arr("strips")),
            S._int32(mesh, arr("gather_idx")), plan, **common)
    if fmt == "ShardedDia":
        return S.ShardedDia(val("data"), mesh, **common)
    if fmt == "ShardedDense":
        return S.ShardedDense(S._ring_panels(val("data"), mesh.shard_ids()),
                              mesh, **common)
    raise ValueError(f"sharded format {fmt!r} is not ported")


def load_sharded_hierarchy(arrays: dict, meta: dict, mesh, dtype=None):
    """The ShardedHierarchy that ``arrays``/``meta`` describe, on ``mesh``
    (this process's shards of arrays that hold all D) at ``dtype``: the
    state of a JAX ShardedHierarchy carried across.

    ``meta = {"levels": [{"n", "lvl", "eig_max", "A": spec, "R_next": spec,
    "P_next": spec, "A_smooth": spec}, ...], "trans_R": spec, "trans_P":
    spec, "replicated": load_hierarchy's meta, "d_active": [...]}``. Level
    ``l`` keeps ``S{l}.inv_diag`` and ``S{l}.{A,R_next,P_next,A_smooth}.*``;
    the transition ``trans_R.*`` / ``trans_P.*``; the tail its
    load_hierarchy arrays under ``tail.``. A spec names its ``format``
    (ShardedEll, ShardedBsr, ShardedStrip8, ShardedDia, ShardedDense),
    ``shape``, ``nnz``, the format's static fields (ShardedEll
    ``reduce_rows``; ShardedStrip8 ``perrow``, ``mode``, ``n_cols_pad``,
    ``n_out``; ShardedDia ``offsets``, ``n_loc``, ``lo_pad``, ``hi_pad``,
    ``compress``; ShardedDense ``compress``), a halo ``plan`` ({"n_local",
    "max_send", "mode", "compress"}, its ``send_idx`` among the arrays) for
    the first three, and a twin's ``dtype``. Arrays: ShardedEll ``cols``,
    ``vals`` and, with a spill, ``spill_rows``, ``spill_cols``,
    ``spill_vals``; ShardedBsr ``blocks``, ``bcols``; ShardedStrip8
    ``idx`` (int8), ``vals``, ``strips``, ``gather_idx``; ShardedDia and
    ShardedDense ``data`` (the dense one in the JAX package's column
    order)."""
    from saena_tpu_torch.parallel.sharded import ShardedHierarchy, ShardedLevel

    dtype = resolve_dtype(dtype)
    levels = []
    for l, spec in enumerate(meta["levels"]):
        mats = {k: load_sharded_operator(arrays, f"S{l}.{k}", spec.get(k), mesh, dtype)
                for k in ("A", "R_next", "P_next", "A_smooth")}
        inv_d = np.asarray(arrays[f"S{l}.inv_diag"], dtype=np.float64)
        levels.append(ShardedLevel(
            inv_diag=torch.from_numpy(inv_d[mesh.local]).to(mesh.device, dtype),
            n=int(spec["n"]), lvl=int(spec["lvl"]), eig_max=spec.get("eig_max"),
            **mats))
    tail = {k[len("tail."):]: v for k, v in arrays.items() if k.startswith("tail.")}
    return ShardedHierarchy(
        sharded=tuple(levels),
        trans_R=load_sharded_operator(arrays, "trans_R", meta["trans_R"], mesh, dtype),
        trans_P=load_sharded_operator(arrays, "trans_P", meta["trans_P"], mesh, dtype),
        replicated=load_hierarchy(tail, meta["replicated"], dtype, mesh.device),
        mesh=mesh, d_active=tuple(meta["d_active"]))

"""Solver options.

One dataclass carries every option of the reference's configuration surface
(`saena::options`, saena.hpp:127-193, plus the public members of
saena_object.h). Field names and defaults are those of `saena_tpu.config`,
with its JSON/XML loaders and writers. `setup_shards` is read by
`AMG.set_matrix` (api.py), `structural_transfers`, `smooth_dtype` and `rap`
by amg/hierarchy.py, the sharded-path policy (`replicate_threshold`,
`shrink_*`, `halo_mode`, `compress_halo`, `halo_dtype`, `float_level`'s
halo wire) by parallel/sharded.py.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class Options:
    # ---- outer solver (ref: saena_object.h:154-157; public defaults saena.hpp) ----
    max_iter: int = 100                # solver_max_iter (public default)
    tol: float = 1e-8                  # relative-residual tolerance (public default)

    # ---- smoothing (ref: saena_object.h:162-168) ----
    smoother: str = "chebyshev"        # "jacobi" | "chebyshev"
    preSmooth: int = 3                 # public default 3 (internal 2)
    postSmooth: int = 3
    jacobi_omega: float = 2.0 / 3.0    # ref: saena_matrix.h:182
    eig: float = 0.0                   # user-provided lambda_max(D^-1 A) for the
                                       # finest level; 0 = estimate (ref set_eig,
                                       # saena.cpp:124-135)

    # ---- coarsening (ref: saena_object.h:41-52, 166-168) ----
    PSmoother: str = "jacobi"          # prolongation smoother: "jacobi" | "SPAI"
    Pomega: float = 2.0 / 3.0          # ref: saena_object.h:168
    connStrength: float = 0.3          # strength-of-connection threshold
    dynamic_levels: bool = True
    adaptive_coarsening: bool = False
    aggregation: str = "dist1"         # "dist1" (reference parity,
                                       # aggregation_1_dist) | "double"
                                       # (composed two-pass, the working
                                       # version of the reference's disabled
                                       # aggregation_2_dist — ~20x less
                                       # coarse-grid nnz on 3-D Poisson)
    max_level: int = 10                # public default (internal 20)
    least_row_threshold: int = 100     # stop coarsening below this global size
    row_reduction_up_thrshld: float = 0.90

    # ---- mixed precision (ref: saena_object.h:69 float_level) ----
    float_level: int = 3               # levels >= this use reduced-precision
                                       # HALO payloads on the sharded path —
                                       # the reference's actual float_level
                                       # semantics: matvec_sparse_float keeps
                                       # val_local/v DOUBLE and sends only
                                       # vSend_f/vecValues_f as MPI_FLOAT
                                       # (saena_matrix_matvec.cpp:448-520),
                                       # so at one rank it is a no-op
    low_dtype: str = "float32"         # wire dtype for those halos; also the
                                       # STORAGE dtype when float_storage
    float_storage: bool = False        # opt-in, MORE aggressive than the
                                       # reference: store A/P/R of levels >=
                                       # float_level at low_dtype (whole-
                                       # operator cast). Off by default: on
                                       # ill-scaled operators (SiH4) the f32
                                       # operator cast cost 53 -> 156 pCG
                                       # iterations while the reference's
                                       # wire-only float path stayed at 55

    # ---- Galerkin filtering (ref: saena_object.h:203-210) ----
    filter_thre: float = 1e-12
    filter_max: float = 1e-8
    filter_start: int = 1
    filter_rate: int = 2               # threshold multiplies by 10^rate per level

    # ---- dense switch (ref: saena_object.h:143-146) ----
    switch_to_dense: bool = True
    dense_thre: float = 0.1
    dense_sz_thre: int = 5000

    # ---- coarsest solve (ref: saena_object.h:155-157, 165) ----
    direct_solver: str = "LU"          # "LU" (dense, replaces SuperLU_DIST) | "CG"
    CG_coarsest_max_iter: int = 150
    CG_coarsest_tol: float = 1e-12

    # ---- sparsification (ref: saena_object.h:195-201) ----
    sample_sz_percent: float = 1.0     # < 1 enables stochastic sparsification of Ac

    # ---- scaling (ref: saena_object.h:53 `scale`) ----
    scale: bool = False                # symmetric D^{-1/2} A D^{-1/2} scaling

    # ---- TPU format policy ----
    reorder_coarse: bool = True        # RCM-reorder coarse operators at setup so
                                       # block formats stay narrow (setup-time row
                                       # reordering, like the reference's repart)
    structural_transfers: bool = True  # apply SA transfers as P_t +/- the level's
                                       # own A matvec (P=(I-wQA)P_t decomposed,
                                       # ops/transfers.py) when cheaper than
                                       # streaming P/R directly; needs symmetric A.
                                       # "force" builds them whenever eligible
                                       # (skips backend/time gates; CPU-CI hook)
    smooth_dtype: str = ""             # when set (e.g. "bfloat16"), smoother/
                                       # residual matvecs INSIDE the V-cycle
                                       # use a reduced-precision copy of each
                                       # level's operator (halved smoother
                                       # bandwidth); the outer Krylov always
                                       # sees the exact operator. Every
                                       # format has its twin, sharing A's
                                       # indices; bf16 values stream
                                       # through the DIA, strip and strip8
                                       # kernels with an f32 x and
                                       # accumulator
    rap: str = "host"                  # Galerkin engine: "host" (native
                                       # Gustavson SpGEMM, the
                                       # mkl_dcsrmultcsr analog) |
                                       # "device" (block-sparse engine,
                                       # ops/bspgemm.py: host symbolic,
                                       # batched block products on the
                                       # hierarchy's device in f64, memory
                                       # ∝ nonzero blocks; the fast_mm
                                       # re-design)
    setup_shards: int = -1             # DEFAULT -1 (auto, one shard per 4
                                       # cores, dist_setup.default_shards):
                                       # run the SHARD-PARALLEL setup
                                       # (parallel/dist_setup.py — per-phase
                                       # row-block tasks with metered halo
                                       # exchanges, the reference's rank-
                                       # distributed setup1/setup2) with a
                                       # bitwise-identical hierarchy; > 0
                                       # forces a shard count; 0 = serial

    # ---- parallel policy (TPU-native analogs of shrink/repart) ----
    switch_repart: bool = True         # density-triggered equi-ROW partition
                                       # switch (ref switch_repart,
                                       # saena_object.h:136 + setup2.cpp:292:
                                       # when on and density >= repart_thre
                                       # the next level splits by rows, not
                                       # nnz). Reference default is false; ours
                                       # is on because equi-row on dense coarse
                                       # levels maps better onto the 128-padded
                                       # device layout (same split either way
                                       # for the sparse fine levels)
    repart_thre: float = 0.1           # density threshold for the switch
                                       # (ref repart_thre, saena_object.h:137;
                                       # set_repart_thre, repart_shrink.cpp:539)
    replicate_threshold: int = 5000    # coarse levels below this global size are replicated
                                       # (analog of processor shrinking to 1 rank, shrink.cpp:67)
    shrink_comm_ratio: float = 0.5     # replicate a level when its worst-device
                                       # halo/work ratio exceeds this (the
                                       # decide_shrinking comm>2x-compute analog;
                                       # 0 disables the cost model)
    shrink_measure: bool = False       # MEASURED shrink decision: time dummy
                                       # sharded matvecs per candidate active-
                                       # device count on the mesh and keep the
                                       # fastest — the reference's actual
                                       # decide_shrinking semantics
                                       # (matvec_dummy timing, saena_matrix_
                                       # shrink.cpp:3-65, 455-531); False uses
                                       # the static halo/work ratio
    shrink_levels: tuple = ()          # per-level bools: may level l shrink?
                                       # (ref set_shrink_levels, saena.hpp:246;
                                       # empty = every level may)
    shrink_values: tuple = ()          # per-level divisors of the active device
                                       # count entering level l (ref
                                       # set_shrink_values / cpu_shrink_thre2;
                                       # 0/1 or missing = decide automatically)
    halo_mode: str = "exchange"        # "exchange" (packed all_to_all) | "allgather"
    compress_halo: bool = False        # ZFP-analog: reduced-precision halo payloads
    halo_dtype: str = "bfloat16"       # payload when compress_halo:
                                       # "bfloat16"|"float16" (rate-16 cast),
                                       # "float8_e4m3fn" (rate-8 cast), or
                                       # "int8_block" (TRUE fixed-rate codec:
                                       # block-scaled int8, shared power-of-2
                                       # exponent per 128-lane chunk — the
                                       # honest saena_matrix_zfp.cpp analog)

    # ---- misc ----
    remove_boundary: bool = False
    verbose: bool = False
    debug: bool = False                # finite-ness/shape assertions around
                                       # setup + solves (the __DEBUG1__/ASSERT
                                       # analog, data_struct.h:72-83; JAX is
                                       # functional so there are no races to
                                       # sanitize — SURVEY.md §5)
    petsc_solver: str = ""             # kept for API parity; unused

    # attribute names of the reference's XML options files
    # (data/options001.xml style; the reference's parser, saena.cpp:444-546,
    # reads them by position, these by name)
    _XML_ALIASES = {
        "solver_max_iter": "max_iter",
        "solver_tol": "tol",
        "conn_str": "connStrength",
        "petsc": "petsc_solver",
    }
    _XML_BOOLS = ("dynamic_levels", "switch_to_dense", "scale",
                  "adaptive_coarsening", "remove_boundary", "compress_halo")

    @classmethod
    def from_file(cls, path: str) -> "Options":
        """Options from JSON, or from the reference's SAENA XML format
        (saena.cpp:444-546, data/options001.xml). Unknown keys raise."""
        if path.endswith(".xml"):
            return cls.from_xml(path)
        with open(path) as f:
            data = json.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_xml(cls, path: str) -> "Options":
        import xml.etree.ElementTree as ET

        root = ET.parse(path).getroot()
        node = root if root.tag == "OPTIONS" else root.find(".//OPTIONS")
        if node is None:
            # the first child of <SAENA>, as the reference reads it
            node = list(root)[0] if len(root) else root
        types = {f.name: type(getattr(cls(), f.name))
                 for f in dataclasses.fields(cls)}
        data = {}
        for key, raw in node.attrib.items():
            name = cls._XML_ALIASES.get(key, key)
            if name not in types:
                raise ValueError(f"unknown option attribute {key!r} in {path}")
            t = types[name]
            if t is bool or name in cls._XML_BOOLS:
                data[name] = raw.strip() in ("1", "true", "True")
            elif t is int:
                data[name] = int(raw)
            elif t is float:
                data[name] = float(raw)
            else:
                data[name] = raw
        return cls(**data)

    @classmethod
    def from_dict(cls, data: dict) -> "Options":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown option(s): {sorted(unknown)}")
        # JSON has no tuples: lists come back as the tuple fields' tuples
        tup = {f.name for f in dataclasses.fields(cls)
               if isinstance(f.default, tuple)}
        data = {k: tuple(v) if k in tup and isinstance(v, list) else v
                for k, v in data.items()}
        return cls(**data)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

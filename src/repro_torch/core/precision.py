"""Precision environment — software analogue of VRP's environment registers.

Counterpart of ``repro/core/precision.py``, field for field. EPAC's VRP
tile exposes runtime-configurable precision through *environment
registers*: the number of significand bits used in computation, and a
separately configurable *memory format* (how values are stored). The
split is mirrored exactly:

  * ``compute_terms`` — how many expansion terms arithmetic carries
    (the chunk count the VPFPU iterates over); K terms of a base dtype with
    ``m`` mantissa bits give roughly ``K * (m+1)`` significand bits.
  * ``store_terms``  — how many terms are kept when a value is written back
    (the paper's extendable IEEE-754 memory format: 128/256/512-bit reprs).

Changing the environment does not change user code: solvers take a
``PrecisionEnv`` and read it at call time. ``dtype`` is a torch dtype.
"""

from __future__ import annotations

import dataclasses

import torch

# Mantissa bits (excluding the implicit leading 1) per base dtype.
_MANT_BITS = {"float32": 23, "float64": 52}
# Veltkamp splitting constants (2^ceil(m/2) + 1) for Dekker's two_prod.
_SPLITTERS = {"float32": float(2**12 + 1), "float64": float(2**27 + 1)}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class PrecisionEnv:
    """Runtime precision configuration (analogue of VRP env registers)."""

    compute_terms: int = 2
    store_terms: int | None = None  # defaults to compute_terms
    base_dtype: str = "float64"
    # Newton refinement steps used by div/sqrt (latency knob, like the
    # VPFPU's iterative chunk pipelines).
    newton_iters: int | None = None

    def __post_init__(self):
        if self.base_dtype not in _MANT_BITS:
            raise ValueError(f"unsupported base dtype {self.base_dtype}")
        if self.compute_terms < 1:
            raise ValueError("compute_terms must be >= 1")
        if self.store_terms is not None and self.store_terms > self.compute_terms:
            raise ValueError("store_terms cannot exceed compute_terms")

    @property
    def K(self) -> int:
        return self.compute_terms

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.base_dtype]

    @property
    def significand_bits(self) -> int:
        """Effective significand width — the paper's headline number.

        K=10 with float64 gives ~530 bits, matching VRP's 512-bit ceiling.
        """
        return self.compute_terms * (_MANT_BITS[self.base_dtype] + 1)

    @property
    def splitter(self) -> float:
        return _SPLITTERS[self.base_dtype]

    @property
    def eps(self) -> float:
        return float(torch.finfo(self.dtype).eps)

    def storage(self) -> "PrecisionEnv":
        """Environment describing the memory format (store_terms wide)."""
        st = self.store_terms or self.compute_terms
        return dataclasses.replace(self, compute_terms=st, store_terms=st)


# Named presets mirroring the paper's memory formats (significand widths).
F64 = PrecisionEnv(compute_terms=1)            # plain double (53 bits)
VP128 = PrecisionEnv(compute_terms=2)          # ~106 bits  ("double-double")
VP256 = PrecisionEnv(compute_terms=5)          # ~265 bits
VP512 = PrecisionEnv(compute_terms=10)         # ~530 bits  (VRP ceiling)

PRESETS = {"f64": F64, "vp128": VP128, "vp256": VP256, "vp512": VP512}


def get_env(name_or_env) -> PrecisionEnv:
    if isinstance(name_or_env, PrecisionEnv):
        return name_or_env
    return PRESETS[str(name_or_env)]

"""Options of the NUFFT ops.

The fields of ``tensorflow_nufft_tpu.options.Options``, as plain
dataclasses (no pydantic) that validate on construction and on
assignment, with the JAX package's validators and messages.

The proto wire format is the JAX package's (the reference's field
numbers), written by the hand-written codec ``proto.nufft_options``:
``to_proto()`` returns the serialized bytes, where the JAX method
returns the protobuf message that serializes to them, and
``from_proto`` takes those bytes or any protobuf message of the
schema. ``show_warnings``, ``verbosity`` and
``kernel_evaluation_method`` are not serialized, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from tensorflow_nufft_tpu_torch.proto import nufft_options as wire

BACKENDS = ("auto", "xla", "pallas", "native")
KERNEL_EVALUATION_METHODS = ("auto", "direct", "horner")


class FftwPlanningRigor(enum.IntEnum):
    """Planning rigor of the FFTW library (compatibility only: no effect
    here, as on the TPU; ``torch.fft`` and the FFT kernel need no
    planning).

    - **AUTO**: selects the planning rigor automatically.
    - **ESTIMATE**: use a simple heuristic instead of measurements.
    - **MEASURE**: find an optimized plan by measuring several transforms.
    - **PATIENT**: like MEASURE, with a wider search.
    - **EXHAUSTIVE**: like PATIENT, with an even wider search.
    """
    AUTO = 0
    ESTIMATE = 1
    MEASURE = 2
    PATIENT = 3
    EXHAUSTIVE = 4

    def to_proto(self) -> int:
        return int(self)

    @classmethod
    def from_proto(cls, pb) -> "FftwPlanningRigor":
        return cls(int(pb))


class PointsRange(enum.IntEnum):
    """Supported range of the nonuniform points.

    - **STRICT**: only values in ``[-pi, pi]`` are supported.
    - **EXTENDED**: values in ``[-3*pi, 3*pi]`` are supported (default).
    - **INFINITE**: any value is supported.
    """
    STRICT = 0
    EXTENDED = 1
    INFINITE = 2

    def to_proto(self) -> int:
        return int(self)

    @classmethod
    def from_proto(cls, pb) -> "PointsRange":
        return cls(int(pb))


def _bool(name, v):
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and v in (0, 1):
        return bool(v)
    raise ValueError(f"{name} must be a bool, got {v!r}")


def _optional_int(name, v):
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"{name} must be an int or None, got {v!r}")
    return v


def _enum(cls, name, v):
    try:
        return cls(v)
    except ValueError:
        raise ValueError(
            f"{name} must be one of {[m.name for m in cls]}, got "
            f"{v!r}") from None


def _sub_options(cls, name, v):
    if isinstance(v, cls):
        return v
    if isinstance(v, dict):
        return cls(**v)
    raise ValueError(f"{name} must be a {cls.__name__}, got {v!r}")


class _Validated:
    """Runs ``_check_<field>`` on every assignment, the constructor's
    included (the JAX models' ``validate_assignment=True``)."""

    def __setattr__(self, name, value):
        check = getattr(type(self), f"_check_{name}", None)
        if check is not None:
            value = check(value)
        super().__setattr__(name, value)


@dataclasses.dataclass
class DebuggingOptions(_Validated):
    """Debugging options.

    Attributes:
        check_points_range: If True, ``nufft`` checks that the nonuniform
            points lie within the supported range (see
            ``Options.points_range``) and raises ``ValueError`` where one
            does not (the JAX package poisons traced outputs with NaN;
            PyTorch runs eagerly, so the check always raises).
    """
    check_points_range: bool = False

    @staticmethod
    def _check_check_points_range(v):
        return _bool("check_points_range", v)

    def to_proto(self) -> bytes:
        """The serialized ``DebuggingOptions`` message."""
        return wire.encode_debugging(self.check_points_range)

    @classmethod
    def from_proto(cls, pb) -> "DebuggingOptions":
        """From serialized bytes or a protobuf message."""
        return cls(check_points_range=wire.decode_debugging(
            wire.as_bytes(pb)))


@dataclasses.dataclass
class FftwOptions(_Validated):
    """FFTW library options, compatibility only.

    Attributes:
        planning_rigor: A ``FftwPlanningRigor``; no effect.
    """
    planning_rigor: FftwPlanningRigor = FftwPlanningRigor.AUTO

    @staticmethod
    def _check_planning_rigor(v):
        return _enum(FftwPlanningRigor, "planning_rigor", v)

    def to_proto(self) -> bytes:
        """The serialized ``FftwOptions`` message."""
        return wire.encode_fftw(int(self.planning_rigor))

    @classmethod
    def from_proto(cls, pb) -> "FftwOptions":
        """From serialized bytes or a protobuf message."""
        return cls(planning_rigor=FftwPlanningRigor(
            wire.decode_fftw(wire.as_bytes(pb))))


@dataclasses.dataclass
class Options(_Validated):
    """Advanced options of the NUFFT ops and ``PlannedNufft``.

    Attributes:
        debugging: A ``DebuggingOptions``.
        fftw: A ``FftwOptions`` (no effect).
        max_batch_size: Optional int; larger inner batches run in
            chunks of this size.
        points_range: A ``PointsRange``; defaults to EXTENDED.
        backend: 'auto', 'xla', 'pallas' or 'native': the route of the
            spread/interp stages (``kernels.dispatch.route``). 'auto' runs
            the hand-written kernels on float32 CUDA tensors, the torch-op
            counterpart of the JAX package's XLA path
            (``kernels.xla_ops``) on float64 CUDA tensors, and the
            kernels' plain versions on CPU tensors; 'xla' takes the
            torch-op path on any device; 'pallas' demands the kernels'
            route (float32) and raises otherwise; 'native' runs the
            spread and interp on the C++/OpenMP host engine
            (``tensorflow_nufft_tpu_torch.native``, built from
            ``cc/nufft_cpu.cc`` with g++ at first use), copying card
            tensors to the host and back; it raises ``RuntimeError``
            where the engine cannot be built.
        upsampling_factor: Optional override of the fine-grid
            oversampling factor sigma (> 1.0); None selects
            automatically.
        show_warnings: Warn when a tolerance below machine precision is
            clamped.
        verbosity: 0 = silent; 1 logs a one-line plan summary per
            transform to stderr.
        kernel_evaluation_method: 'auto', 'direct' or 'horner'. 'auto'
            picks the fitted Horner polynomial for float32 plans and
            direct exp/sqrt for float64.
    """
    debugging: DebuggingOptions = dataclasses.field(
        default_factory=DebuggingOptions)
    fftw: FftwOptions = dataclasses.field(default_factory=FftwOptions)
    max_batch_size: Optional[int] = None
    points_range: PointsRange = PointsRange.EXTENDED
    backend: str = "auto"
    upsampling_factor: Optional[float] = None
    show_warnings: bool = True
    verbosity: int = 0
    kernel_evaluation_method: str = "auto"

    @staticmethod
    def _check_debugging(v):
        return _sub_options(DebuggingOptions, "debugging", v)

    @staticmethod
    def _check_fftw(v):
        return _sub_options(FftwOptions, "fftw", v)

    @staticmethod
    def _check_max_batch_size(v):
        v = _optional_int("max_batch_size", v)
        if v is not None and v < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {v}")
        return v

    @staticmethod
    def _check_points_range(v):
        return _enum(PointsRange, "points_range", v)

    @staticmethod
    def _check_backend(v):
        if v not in BACKENDS:
            raise ValueError(
                f"backend must be one of 'auto', 'xla', 'pallas', "
                f"'native', got {v!r}")
        return v

    @staticmethod
    def _check_upsampling_factor(v):
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(
                f"upsampling_factor must be a float or None, got {v!r}")
        if v <= 1.0:
            raise ValueError(f"upsampling_factor must be > 1.0, got {v}")
        return float(v)

    @staticmethod
    def _check_show_warnings(v):
        return _bool("show_warnings", v)

    @staticmethod
    def _check_verbosity(v):
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"verbosity must be an int, got {v!r}")
        if v < 0:
            raise ValueError(f"verbosity must be >= 0, got {v}")
        return v

    @staticmethod
    def _check_kernel_evaluation_method(v):
        if v not in KERNEL_EVALUATION_METHODS:
            raise ValueError(
                f"kernel_evaluation_method must be one of 'auto', "
                f"'direct', 'horner', got {v!r}")
        return v

    def to_proto(self) -> bytes:
        """The serialized ``Options`` message (the JAX package's
        ``to_proto().SerializeToString()``, byte for byte): the
        submessages always, a zero scalar never, ``backend`` only when
        not 'auto' and ``upsampling_factor`` only when set."""
        return wire.encode_options(
            self.debugging.to_proto(), self.fftw.to_proto(),
            self.max_batch_size, int(self.points_range), self.backend,
            self.upsampling_factor)

    @classmethod
    def from_proto(cls, pb) -> "Options":
        """From serialized bytes or a protobuf message: unset or zero
        fields take their defaults (None, 'auto'), as in the JAX
        package."""
        fields = wire.decode_options(wire.as_bytes(pb))
        return cls(
            debugging=DebuggingOptions(
                check_points_range=fields["debugging"]),
            fftw=FftwOptions(planning_rigor=fields["fftw"]),
            max_batch_size=fields["max_batch_size"] or None,
            points_range=PointsRange(fields["points_range"]),
            backend=fields["backend"] or "auto",
            upsampling_factor=fields["upsampling_factor"] or None,
        )

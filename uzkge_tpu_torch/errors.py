"""Structured error types mirroring the reference's `UzkgeError` enum
(the reference's `uzkge/src/errors.rs:5-45`).

The reference propagates a single error enum through `Result`; here the
equivalent is an exception hierarchy rooted at `UzkgeError` so callers can
catch the whole family or a specific class.  Every class below is raised by
the framework (see tests/test_errors.py); reference enum variants whose
failure mode cannot occur in this design are intentionally NOT mirrored as
dead classes — verification failures are returned as booleans (like the
reference's SDK layer collapsing `Result<(), VerificationError>`), and
trace-time shape/typing violations surface as Python TypeError/AssertionError
during circuit construction.
"""


class UzkgeError(Exception):
    """Base class for all framework errors."""


class DeserializationError(UzkgeError):
    """Could not deserialize object (reference: `DeserializationError`)."""


class ParameterError(UzkgeError):
    """Unexpected parameter for method or function (reference:
    `ParameterError`)."""


class MissingVerifierParamsError(UzkgeError):
    """Loading verifier parameters that are not embedded (reference:
    `MissingVerifierParamsError`)."""


class MissingSRSError(UzkgeError):
    """No SRS available for the requested size (reference:
    `MissingSRSError`)."""


class DegreeError(UzkgeError):
    """Polynomial degree above the maximum supported by the SRS
    (reference: `DegreeError`)."""


class GroupNotFound(UzkgeError):
    """No evaluation domain of the requested size (reference:
    `GroupNotFound(usize)`)."""

    def __init__(self, size: int):
        super().__init__(f"group not found of size {size}")
        self.size = size


class ProofError(UzkgeError):
    """Malformed or inconsistent proof bytes."""


class DanglingWitnessError(UzkgeError):
    """A witness variable was allocated but never used in any gate — the
    analogue of the reference `debug` feature's dangling-witness panic
    (turbo/mod.rs:979-1001)."""

    def __init__(self, variables, origins=None):
        self.variables = sorted(variables)
        self.origins = origins or {}
        msg = f"dangling witness variables (allocated, never constrained): {self.variables[:16]}"
        if len(self.variables) > 16:
            msg += f" ... ({len(self.variables)} total)"
        for v in self.variables[:4]:
            if v in self.origins:
                msg += f"\n  var {v} allocated at:\n{self.origins[v]}"
        super().__init__(msg)

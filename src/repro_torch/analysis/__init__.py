"""Determinism tooling: ``simlint`` (static rules) + ``simsan`` (runtime
sanitizer for the event loop).  CLI: ``python -m repro_torch.analysis --check``.
The rule catalog and workflow are the JAX package's (``docs/simlint.md``)."""
from repro_torch.analysis.simlint import (  # noqa: F401
    Finding, RULES, lint_paths, lint_source,
)
from repro_torch.analysis.simsan import (  # noqa: F401
    SanitizerError, check_payment_conservation,
)

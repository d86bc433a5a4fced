"""Deprecation helper: warnings attributed to the true external caller.

Legacy spellings (tuple-only strategies, ``engine="fast"``) funnel through
normalization shims several frames below the code that actually wrote the
old form. :func:`warn_deprecated` walks the stack past the named shim
modules so the ``DeprecationWarning`` carries the *caller's* module — which
is what makes the CI policy work: pytest escalates deprecation warnings
originating from ``repro_torch.*`` modules to errors (see ``pyproject.toml``),
so no repo-internal code can keep using a deprecated form, while external
callers just see an ordinary attributed warning.
"""
from __future__ import annotations

import sys
import warnings


def warn_deprecated(message: str, *, skip: tuple[str, ...] = ()) -> None:
    """Emit a ``DeprecationWarning`` attributed past the shim modules.

    ``skip`` lists module names (``__name__`` values) that are pass-through
    normalization layers; the warning is attributed to the nearest frame
    belonging to none of them (nor to this module).
    """
    skipped = set(skip) | {__name__}
    level = 2
    frame = sys._getframe(1)
    while frame is not None and frame.f_globals.get("__name__") in skipped:
        frame = frame.f_back
        level += 1
    warnings.warn(message, DeprecationWarning, stacklevel=level)

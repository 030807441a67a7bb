"""Repo-root pytest hook: lets the JAX reference package import on JAX
releases that moved `enable_x64` out of `jax.experimental`.

`repro.kernels.ops` and `repro.core.expr` import
`jax.experimental.enable_x64`; newer JAX exposes the same context manager
as `jax.enable_x64` only.  The alias is installed before any test module
imports the reference, and is a no-op where the old name still exists.

Hypothesis replays the examples stored under `.hypothesis/examples` but
neither adds nor prunes any, so a test run leaves those files as they are.
"""

from hypothesis import settings
from hypothesis.database import (DirectoryBasedExampleDatabase,
                                 ReadOnlyDatabase)

settings.register_profile("repo", database=ReadOnlyDatabase(
    DirectoryBasedExampleDatabase(".hypothesis/examples")))
settings.load_profile("repo")

try:
    import jax
    import jax.experimental as _jax_experimental
except ImportError:      # JAX absent: only the torch port's tests can run
    pass
else:
    if (not hasattr(_jax_experimental, "enable_x64")
            and hasattr(jax, "enable_x64")):
        _jax_experimental.enable_x64 = jax.enable_x64

"""``ftpipehd_torch`` — the paper-named alias for the ``repro_torch``
package, as ``ftpipehd`` is for ``repro``.

``ftpipehd_torch.run`` is the supported entry point (RunConfig / Run /
start_run). It imports neither JAX nor the reference package."""
import sys

from repro_torch import run

# make ``from ftpipehd_torch.run import Run`` work: the alias must be a
# real importable submodule, not just an attribute of this package
sys.modules[__name__ + ".run"] = run

__all__ = ["run"]

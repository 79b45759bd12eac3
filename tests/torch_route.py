"""One hashing route for both packages in the port's comparison tests.

Each package hashes for HLL, the top-k store and the duplicate tracker
through its C++ library (``native``) or, where that cannot load, through
its numpy/pandas fallback.  The two routes are two hash families: a value
hashes differently on each, so HLL-derived counts can differ between a
package on one route and a package on the other.  The port builds its
library atomically (a temporary file, then a rename); the reference writes
its shared object in place, so under several test workers starting on a
fresh tree one of them can find a half-written file and fall back.

``same_hash_route`` puts the package that has its library on its fallback
too whenever exactly one of the two has it, for the module that imports the
fixture (module scope: the comparisons compute their stats in module-scoped
fixtures), and restores it afterwards.  It edits no file of either
package.
"""

import pytest

from tpuprof import native as ref_native
from tpuprof_torch import native as port_native


def hold_one_route(mp: pytest.MonkeyPatch) -> str:
    """Through ``mp``, put both packages on one hashing route; returns
    ``"native"`` or ``"fallback"``."""
    ref_ok, port_ok = ref_native.available(), port_native.available()
    if ref_ok == port_ok:
        return "native" if ref_ok else "fallback"
    lone = ref_native if ref_ok else port_native
    mp.setattr(lone, "_tried", True)
    mp.setattr(lone, "_lib", None)
    return "fallback"


@pytest.fixture(scope="module", autouse=True)
def same_hash_route():
    with pytest.MonkeyPatch.context() as mp:
        yield hold_one_route(mp)

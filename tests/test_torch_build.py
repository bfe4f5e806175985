"""Where ``openmeasure_torch._build`` puts a kernel's library (CPU: no
compiler runs here)."""

from openmeasure_torch import _build


def test_library_path_names_its_defines_and_its_flags():
    """A build with defines is a library of its own, its defines in its
    name; the plain build's path does not depend on any define."""
    plain = _build._lib_path("chol")
    stamped = _build._lib_path("chol", ("CHOL_STAMPS",))
    assert plain.parent == stamped.parent == _build.BUILD_DIR
    assert plain.name.startswith("libchol-") and plain.suffix == ".so"
    assert stamped.name.startswith("libchol-chol_stamps-")
    assert plain != stamped and plain == _build._lib_path("chol", ())
    assert _build._flags(("CHOL_STAMPS",)) == _build.NVCC_FLAGS + (
        "-DCHOL_STAMPS",)
    assert _build._lib_path("qrcp") != plain

"""The kernel library's build key (``repro_torch.kernels._build``), on the
CPU: no ``nvcc`` is run."""
from repro_torch.kernels import _build


def test_digest_covers_included_headers(tmp_path, monkeypatch):
    """``nvcc`` compiles the ``.cu`` files only, and an edit to a header they
    include gives another library name, so a stale build is never reused."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("constexpr int BK = 32;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.sources() == [tmp_path / "a.cu"]
    before = _build._digest()
    assert _build._digest() == before
    header.write_text("constexpr int BK = 16;\n")
    assert _build._digest() != before

"""The port's native MovieLens parser (``csrc/ingest.cc`` through
``data/native.py``) against the JAX package's ``load_movielens`` and against
the port's own Python parser, array for array, on well-formed and malformed
files. The library is built here with g++; a failed build fails the test.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from ycnr_tpu.data import movielens as jml
from ycnr_tpu_torch.data import movielens as tml
from ycnr_tpu_torch.data import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(seed, n=200, ts=True):
    rng = np.random.default_rng(seed)
    u = rng.integers(1, 40, n)
    i = rng.integers(1, 500, n)
    r = rng.integers(1, 11, n) * 0.5
    t = rng.integers(789_652_009, 1_427_784_002, n)
    return [(a, b, f"{c:g}") + ((d,) if ts else ())
            for a, b, c, d in zip(u, i, r, t)]


def _text(rows, sep, eol="\n", header=None):
    lines = [sep.join(str(x) for x in row) for row in rows]
    if header:
        lines.insert(0, header)
    return eol.join(lines) + eol


# name -> (extension, file text); every file keeps some well-formed rows
FILES = {
    "csv": (".csv", _text(_rows(0), ",")),
    "dat": (".dat", _text(_rows(1), "::")),
    "tab": (".data", _text(_rows(2), "\t")),
    "header": (".csv", _text(_rows(3), ",",
                             header="userId,movieId,rating,timestamp")),
    "blank_lines": (".csv", "\n\n" + _text(_rows(4), ",").replace(
        "\n", "\n\n", 7) + "\n"),
    "crlf": (".csv", _text(_rows(5), ",", eol="\r\n",
                           header="userId,movieId,rating,timestamp")),
    "crlf_dat": (".dat", _text(_rows(6), "::", eol="\r\n")),
    "short_rows": (".csv", _text(_rows(7)[:50] + [(7,), (7, 9)]
                                 + _rows(8)[:50] + [(3, "")], ",")),
    "non_numeric": (".csv", _text(
        _rows(9)[:40] + [("abc", 1, "3.0", 5), (1, "x", "3.0", 5),
                         (1, 2, "n/a", 5)] + _rows(10)[:40], ",")),
    "missing_ts": (".csv", _text(_rows(11, ts=False), ",")),
    "mixed_ts": (".dat", _text(_rows(12)[:30] + _rows(13, ts=False)[:30]
                               + [(5, 6, "4.5", "later")], "::")),
    "no_final_newline": (".data", _text(_rows(14), "\t").rstrip("\n")),
    "negative_and_exponent": (".csv", _text(
        [(1, 2, "-1.5", 7), (3, 4, "2e0", 8), (5, 6, "+3.25", 9)], ",")),
    "nothing_parseable": (".csv", "a,b,c\nx,y,z\n"),
    "empty": (".csv", ""),
}


@pytest.fixture(scope="module")
def lib():
    """The port's parser library, built here if it is not yet."""
    built = native.load_library()
    assert built is not None, "g++ not found: the native parser cannot build"
    return built


def _write(tmp_path, name):
    ext, text = FILES[name]
    p = str(tmp_path / f"ratings{ext}")
    with open(p, "w", newline="") as f:
        f.write(text)
    return p


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("kw", [
    {}, {"return_ts": True}, {"return_maps": True},
    {"densify": False, "return_maps": True, "return_ts": True}],
    ids=["plain", "ts", "maps", "raw_maps_ts"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_load_movielens_equals_the_jax_package(lib, tmp_path, name, kw):
    p = _write(tmp_path, name)
    _assert_same(tml.load_movielens(p, **kw), jml.load_movielens(p, **kw))


@pytest.mark.parametrize("want_ts", [False, True])
@pytest.mark.parametrize("name", sorted(set(FILES) - {"nothing_parseable"}))
def test_native_parser_equals_python_parser(lib, tmp_path, name, want_ts):
    p = _write(tmp_path, name)
    sep = tml._sep_for(p)
    got = native.parse_ratings_native(p, sep, want_ts=want_ts)
    want = tml._parse_python(p, sep, want_ts=want_ts)
    assert got is not None and len(got) == len(want) == 3 + want_ts
    assert got[0].dtype == got[1].dtype == np.int32
    assert got[2].dtype == np.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name not in ("empty",):
        assert len(got[0]) > 0


def test_native_parser_defers_when_nothing_parses(lib, tmp_path):
    """Content but no readable row is -2: the caller parses in Python."""
    p = _write(tmp_path, "nothing_parseable")
    assert native.parse_ratings_native(p, ",") is None
    assert native.parse_ratings_native(p, ",", want_ts=True) is None
    assert tml.load_movielens(p)[3:] == (0, 0)


def test_missing_file_raises(lib, tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_ratings_native(str(tmp_path / "none.csv"), ",")
    with pytest.raises(FileNotFoundError):
        tml.load_movielens(str(tmp_path / "none.csv"))


def test_load_movielens_goes_through_the_native_parser(lib, tmp_path,
                                                       monkeypatch):
    p = _write(tmp_path, "csv")

    def no_python(*a, **k):
        raise AssertionError("the Python parser ran")

    monkeypatch.setattr(tml, "_parse_python", no_python)
    assert len(tml.load_movielens(p)[0]) == 200


def test_python_parser_serves_a_host_without_gxx(tmp_path, monkeypatch):
    p = _write(tmp_path, "header")
    want = tml.load_movielens(p, return_ts=True)
    monkeypatch.setattr(tml, "parse_ratings_native", lambda *a, **k: None)
    _assert_same(tml.load_movielens(p, return_ts=True), want)


_BUILD_AND_PARSE = textwrap.dedent("""
    import sys
    from ycnr_tpu_torch.data import native
    native.BUILD_DIR = sys.argv[1]
    got = native.parse_ratings_native(sys.argv[2], ",", want_ts=True)
    print(len(got[0]), int(got[0].sum()), int(got[3].sum()))
""")


def test_six_processes_building_at_once_all_load(tmp_path):
    """Six processes find no library and build it together into one
    directory; each loads a whole file and parses the same rows."""
    p = _write(tmp_path, "csv")
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_PARSE,
                               build, p], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [pr.communicate(timeout=300) for pr in procs]
    assert [pr.returncode for pr in procs] == [0] * 6, [e for _, e in outs]
    u, _, _, t = tml._parse_python(p, ",", want_ts=True)
    want = f"{len(u)} {int(u.sum())} {int(t.sum())}"
    assert [o.strip() for o, _ in outs] == [want] * 6
    left = os.listdir(build)
    assert len(left) == 1 and left[0].endswith(".so"), left


def test_build_command_and_library_name():
    cmd = native.gxx_command("g++", "a.cc", "lib.so")
    assert cmd[0] == "g++" and "-shared" in cmd and "-fPIC" in cmd
    assert "-march=native" not in cmd
    assert os.path.basename(native.library_path()).startswith(
        "libycnr_ingest-")
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR

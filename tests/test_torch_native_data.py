"""The port's native data loader (``kubetpu_torch/jobs/native_data.py`` over
its own ``kubetpu_torch/dataio/loader.cc``) against the JAX package's
``TokenFile`` on the same corpus files: gathered rows, seeded batches and
worker shards are byte-equal (exact: both sides copy integers), and the
error cases raise the same types.

The port's library builds itself at first use into ``build/kubetpu_torch/``.
The JAX side's library is built here, into this module's temporary
directory with the Makefile's flags, and named through
``KUBETPU_DATAIO_PATH`` — nothing reads or writes ``_output/``."""

import os
import subprocess

import numpy as np
import pytest

from kubetpu.jobs import native_data as jnative
from kubetpu_torch.jobs import native_data as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKE_FLAGS = ["-O2", "-Wall", "-Wextra", "-std=c++17", "-shared", "-fPIC"]


@pytest.fixture(scope="module", autouse=True)
def jax_loader(tmp_path_factory):
    """The JAX package's loader, built from ``kubetpu/dataio/loader.cc``
    into a temporary directory and loaded through ``KUBETPU_DATAIO_PATH``
    (its cached handle is set aside for this module and restored
    after)."""
    lib = tmp_path_factory.mktemp("jax_dataio") / "libkubetpu_dataio.so"
    subprocess.run(["g++", *MAKE_FLAGS, "-o", str(lib),
                    os.path.join(REPO, "kubetpu", "dataio", "loader.cc")],
                   check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("KUBETPU_DATAIO_PATH", str(lib))
    mp.setattr(jnative, "_LIB", None)
    yield lib
    mp.undo()


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 50_000, size=10_000).astype(np.uint16)
    path = tmp_path / "corpus.bin"
    tnative.write_token_file(str(path), tokens)
    return str(path), tokens


def test_write_token_file_bytes_equal_jax(tmp_path):
    tokens = np.random.default_rng(1).integers(0, 65_536, 777)
    for dtype in (np.uint16, np.uint32):
        a, b = tmp_path / "a.bin", tmp_path / "b.bin"
        jnative.write_token_file(str(a), tokens, dtype=dtype)
        tnative.write_token_file(str(b), tokens, dtype=dtype)
        assert a.read_bytes() == b.read_bytes()


def test_gather_matches_numpy_and_jax(corpus):
    path, tokens = corpus
    offsets = np.asarray([0, 17, 9000, len(tokens) - 64])
    with tnative.TokenFile(path) as tf, jnative.TokenFile(path) as jf:
        assert tf.num_tokens == jf.num_tokens == len(tokens)
        rows = tf.gather(offsets, 64)
        assert rows.dtype == np.int32
        assert rows.tobytes() == jf.gather(offsets, 64).tobytes()
        for i, off in enumerate(offsets):
            np.testing.assert_array_equal(
                rows[i], tokens[off:off + 64].astype(np.int32))


def test_uint32_corpus_matches_jax(tmp_path):
    tokens = np.arange(100_000, 100_500, dtype=np.uint32)
    path = str(tmp_path / "c32.bin")
    tnative.write_token_file(path, tokens, dtype=np.uint32)
    with tnative.TokenFile(path, dtype_bytes=4) as tf, \
            jnative.TokenFile(path, dtype_bytes=4) as jf:
        rows = tf.gather(np.asarray([10, 480]), 5)
        np.testing.assert_array_equal(rows[0], tokens[10:15].astype(np.int32))
        assert rows.tobytes() == jf.gather(np.asarray([10, 480]), 5).tobytes()


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_batches_equal_jax(corpus, seed):
    """The same seed draws the same windows as the JAX TokenFile: tokens
    and targets byte-equal over several batches, targets shifted by one."""
    path, _tokens = corpus
    with tnative.TokenFile(path) as tf, jnative.TokenFile(path) as jf:
        mine, theirs = tf.batches(4, 32, seed=seed), jf.batches(4, 32,
                                                               seed=seed)
        for _ in range(4):
            (t, y), (jt, jy) = next(mine), next(theirs)
            assert t.tobytes() == jt.tobytes() and y.tobytes() == jy.tobytes()
            np.testing.assert_array_equal(t[:, 1:], y[:, :-1])


def test_worker_shards_disjoint_and_equal_jax(corpus):
    """Each worker's windows come from its own contiguous span, the same
    windows as the JAX package's worker; the two spans never overlap."""
    path, tokens = corpus
    span = len(tokens) // 2
    with tnative.TokenFile(path) as tf, jnative.TokenFile(path) as jf:
        seen = {}
        for w in range(2):
            t, _ = next(tf.batches(64, 4, seed=5, worker=w, num_workers=2))
            jt, _ = next(jf.batches(64, 4, seed=5, worker=w, num_workers=2))
            assert t.tobytes() == jt.tobytes()
            seen[w] = t
        assert not np.array_equal(seen[0], seen[1])
        # the offsets each worker drew lie inside its own span
        for w in range(2):
            rng = np.random.default_rng((5, w))
            offs = rng.integers(w * span, w * span + span - 5 + 1, size=64)
            assert offs.min() >= w * span and offs.max() + 5 <= (w + 1) * span
            for row, off in zip(seen[w], offs):
                np.testing.assert_array_equal(
                    row, tokens[off:off + 4].astype(np.int32))
        with pytest.raises(ValueError):
            next(tf.batches(1, 4, worker=2, num_workers=2))


def test_error_cases_raise_like_jax(corpus, tmp_path):
    path, tokens = corpus
    for mod in (tnative, jnative):
        with mod.TokenFile(path) as tf:
            with pytest.raises(ValueError):
                tf.gather(np.asarray([len(tokens) - 3]), 8)
            with pytest.raises(ValueError):
                tf.gather(np.asarray([-1]), 8)
            with pytest.raises(ValueError):
                tf.gather(np.asarray([[0]]), 8)
        with pytest.raises(OSError):
            mod.TokenFile(str(tmp_path / "nope.bin"))
        with pytest.raises(ValueError):
            mod.TokenFile(str(tmp_path / "x"), dtype_bytes=3)
        with pytest.raises(ValueError):
            mod.write_token_file(str(tmp_path / "bad.bin"),
                                 np.asarray([1, 70_000]))
        tf = mod.TokenFile(path)
        tf.close()
        tf.close()                                  # idempotent
        with pytest.raises(ValueError, match="closed"):
            tf.gather(np.asarray([0]), 4)
        with mod.TokenFile(path) as tf:
            with pytest.raises(ValueError, match="shorter"):
                next(tf.batches(1, len(tokens), seed=0))


def test_dropped_tokenfile_is_finalized(corpus):
    """The finalizer closes the mapping of a TokenFile that was never
    closed."""
    import gc

    path, _tokens = corpus
    tf = tnative.TokenFile(path)
    fin = tf._finalizer
    assert fin.alive
    del tf
    gc.collect()
    assert not fin.alive


def test_first_use_builds_into_a_fresh_directory(tmp_path, monkeypatch):
    """With no build present the loader compiles ``loader.cc`` into the
    build directory under a name hashing the source (a per-pid temporary
    file renamed into place, none left behind), loads it, and the next
    first use finds it without compiling; an edited source moves the
    name."""
    build = tmp_path / "build"
    monkeypatch.setattr(tnative, "BUILD_DIR", build)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.delenv(tnative.PATH_ENV, raising=False)
    tnative._lib()
    lib = tnative.lib_path()
    assert lib.parent == build and lib.exists()
    assert lib.name.startswith("libkubetpu_dataio-") and lib.suffix == ".so"
    assert tnative.BUILD_SECONDS > 0
    assert [p.name for p in build.iterdir()] == [lib.name]
    monkeypatch.setattr(tnative, "_LIB", None)
    tnative._lib()
    assert tnative.BUILD_SECONDS == 0.0

    src = tmp_path / "loader.cc"
    src.write_text(tnative.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(tnative, "SOURCE", src)
    assert tnative.lib_path() != lib


def test_path_override_and_build_failure(tmp_path, monkeypatch):
    """``KUBETPU_TORCH_DATAIO_PATH`` names a prebuilt library (nothing is
    compiled); a source that does not compile raises with the compiler's
    output and leaves no temporary file."""
    prebuilt = tmp_path / "prebuilt.so"
    subprocess.run(["g++", *MAKE_FLAGS, "-o", str(prebuilt),
                    str(tnative.SOURCE)], check=True, capture_output=True)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "unused")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv(tnative.PATH_ENV, str(prebuilt))
    assert tnative._lib()._name == str(prebuilt)
    assert not (tmp_path / "unused").exists()

    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b2")
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.build()
    assert list((tmp_path / "b2").iterdir()) == []

"""Hardware test lane: the engine compiled for a real NVIDIA GPU.

The default suite runs on the CPU, the Hopper kernel in Pallas interpret
mode, which checks semantics but not the Triton lowering. This lane
compiles everything for the card. Every test takes the ``gpu`` fixture,
which skips when JAX's backend is not a GPU.

Run on a GPU host:

    LIBSSA_TEST_ACCELERATOR=1 python -m pytest -m gpu tests/test_gpu.py

``chip_smoke.py`` runs this lane as its last phase.
"""
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.constants import BitWidth, SymType
from libssa_tpu.io.db import PAD_CODE, SequenceDB
from libssa_tpu.ops.scoring import make_padded_profile
from libssa_tpu.search.manager import SearchEngine, SearchParams, SearchStats

pytestmark = pytest.mark.gpu

B62 = matrices.builtin("BLOSUM62")


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("hardware lane: needs a GPU backend")


def _chunk(rng, B, n, short_lanes):
    """(n, B) int8 code stack; ``short_lanes`` get lengths <= 40 so the
    scalar oracle can check them at large query lengths."""
    lengths = rng.integers(1, n + 1, B).astype(np.int32)
    lengths[short_lanes] = rng.integers(1, 41, len(short_lanes))
    codes = rng.integers(0, 20, (n, B)).astype(np.int8)
    codes[np.arange(n)[:, None] >= lengths[None, :]] = PAD_CODE
    return codes, lengths


@pytest.mark.parametrize("m", [144, 1000, 5478])
@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_kernel_exact_at_real_widths(gpu, m, local):
    """The compiled Hopper kernel == the XLA scan on all 8,192 lanes
    (scores, hi, lo) and == the int64 oracle on sampled lanes."""
    import jax.numpy as jnp

    from libssa_tpu.search import kernels

    rng = np.random.default_rng(m + local)
    B, n = 8192, 256
    short = rng.choice(B, 8, replace=False)
    q = rng.integers(0, 20, m).astype(np.uint8)
    prof = jnp.asarray(make_padded_profile(q, B62.padded()), jnp.int32)
    codes, lengths = _chunk(rng, B, n, short)
    stacks = [(jnp.asarray(codes)[None], jnp.asarray(lengths)[None])]
    out = {}
    for route in ("pallas", "scan"):
        [got] = kernels.sweep_groups(
            route, *kernels.single_query(prof, stacks, m), 11, 1,
            local=local, use_matmul=False, track_range=True, dtype=jnp.int32,
        )
        out[route] = [np.asarray(x)[0] for x in got]
    for a, b in zip(out["pallas"], out["scan"]):
        np.testing.assert_array_equal(a, b)
    fn = oracle.sw_score if local else oracle.nw_score
    want = [
        fn(q, codes[: lengths[b], b].astype(np.uint8), B62.scores, 10, 1)
        for b in short
    ]
    np.testing.assert_array_equal(out["pallas"][0][short], want)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_bit64_lane_beyond_int32_on_gpu(gpu, local):
    """Scores int32 cannot hold: the direct BIT64 lane and the EXACT
    ladder's int64 terminal rung both equal the int64 oracle, and the
    score bound keeps such searches off the int32 kernel."""
    from libssa_tpu.search import kernels

    mat = matrices.constant_scoring(2**28, -4, SymType.NUCLEOTIDE)
    rng = np.random.default_rng(11)
    hot = np.tile(np.arange(4, dtype=np.uint8), 5)
    seqs = [rng.integers(0, 4, int(L)).astype(np.uint8) for L in (9, 30, 17)]
    seqs.append(hot)
    db = SequenceDB.from_sequences(
        [f"s{i}" for i in range(len(seqs))], seqs, SymType.NUCLEOTIDE
    )
    fn = oracle.sw_score if local else oracle.nw_score
    want = np.asarray([fn(hot, s, mat.scores, 10, 2) for s in seqs], np.int64)
    assert want.max() > 2**31
    eng = SearchEngine(db, mat, 10, 2, SearchParams(batch_size=8))
    assert eng._route(32, "float32") == "scan"
    assert kernels.route(None, "int32") == "pallas"
    np.testing.assert_array_equal(
        eng.score_all(hot, local=local, bit_width=BitWidth.BIT64), want
    )
    stats = SearchStats()
    np.testing.assert_array_equal(eng.score_all(hot, local=local, stats=stats), want)
    assert any(v > 0 for v in stats.rescored.values()), stats.rescored


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_onehot_dot_exact_on_gpu(gpu, dtype):
    """The scan's one-hot dot gather is exact on the card: f32 with
    precision=HIGHEST for entries far beyond TF32's 2,048 integer range,
    and the s8 x s8 -> s32 dot (int32 path) for |entry| <= 127."""
    import jax.numpy as jnp

    from libssa_tpu.ops import interseq

    rng = np.random.default_rng(3)
    m, B = 64, 256
    hi = 2**20 if dtype == "float32" else 127
    prof = rng.integers(-hi, hi + 1, (m, 32)).astype(np.int32)
    s_t = rng.integers(0, 32, B).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.int32
    dot_prof = jnp.asarray(prof, jnp.int8 if dtype == "int32" else jdt)
    got = interseq._profile_column(
        jnp.asarray(prof, jdt), dot_prof, jnp.asarray(s_t), True, jdt
    )
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), prof[:, s_t])


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_longpair_scan_route_on_gpu(gpu, local):
    """The single-pair row-sweep (align_pair SCORE mode) == the oracle,
    in its f32 window and in int32 beyond it."""
    from libssa_tpu.ops.longpair import longpair_score

    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, 600).astype(np.uint8)
    s = rng.integers(0, 20, 700).astype(np.uint8)
    fn = oracle.sw_score if local else oracle.nw_score
    assert longpair_score(q, s, B62.padded(), 10, 1, local) == fn(
        q, s, B62.scores, 10, 1
    )
    big = matrices.constant_scoring(2**20, -3, SymType.NUCLEOTIDE)
    qn = rng.integers(0, 4, 300).astype(np.uint8)
    sn = np.concatenate([qn[50:250], rng.integers(0, 4, 90).astype(np.uint8)])
    assert longpair_score(qn, sn, big.padded(), 10, 2, local) == fn(
        qn, sn, big.scores, 10, 2
    )


def test_search_engine_end_to_end_on_gpu(gpu):
    """Full engine search on the card matches the oracle hit list."""
    from libssa_tpu.ops.topk import host_topk

    rng = np.random.default_rng(20261016)
    q = rng.integers(0, 24, 47).astype(np.uint8)
    subjects = [
        rng.integers(0, 24, int(L)).astype(np.uint8)
        for L in rng.integers(10, 200, 300)
    ]
    db = SequenceDB.from_sequences(
        [f"s{i}" for i in range(len(subjects))], subjects, SymType.AMINOACID
    )
    engine = SearchEngine(db, B62, 10, 1)
    want = np.array([oracle.sw_score(q, s, B62.scores, 10, 1) for s in subjects])
    ws, wi = host_topk(want, np.arange(len(want)), 10)
    for bw in (BitWidth.EXACT, BitWidth.BIT8, BitWidth.BIT16):
        scores, ids = engine.search(q, 10, True, bw)
        np.testing.assert_array_equal(np.asarray(scores), ws)
        np.testing.assert_array_equal(np.asarray(ids), wi)

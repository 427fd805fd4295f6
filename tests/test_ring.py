"""Device-spanning ring DP (parallel/ring.py) vs the scalar oracle.

Runs on the 8-virtual-device CPU mesh from conftest.py — the collective
boundary exchange (ppermute) is exercised for real across shards.
"""
import numpy as np
import pytest

from libssa_tpu import matrices, oracle
from libssa_tpu.parallel.ring import ring_score
from libssa_tpu.parallel.sharded import make_db_mesh

B62 = matrices.builtin("BLOSUM62")


@pytest.fixture(scope="module")
def mesh():
    return make_db_mesh()


@pytest.mark.parametrize("m,n", [(128, 1024), (100, 777), (64, 64), (96, 40)])
def test_ring_sw_matches_oracle(mesh, m, n):
    rng = np.random.default_rng(m * 1000 + n)
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    got = ring_score(q, s, B62.padded(), 11, 1, local=True, mesh=mesh, RB=32)
    assert got == oracle.sw_score(q, s, B62.scores, 11, 1)


@pytest.mark.parametrize("m,n", [(128, 1024), (128, 777), (64, 111)])
def test_ring_nw_matches_oracle(mesh, m, n):
    rng = np.random.default_rng(m * 1000 + n + 7)
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    got = ring_score(q, s, B62.padded(), 11, 1, local=False, mesh=mesh, RB=32)
    assert got == oracle.nw_score(q, s, B62.scores, 11, 1)


def test_ring_single_device():
    mesh1 = make_db_mesh(1)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 20, 70).astype(np.uint8)
    s = rng.integers(0, 20, 200).astype(np.uint8)
    got = ring_score(q, s, B62.padded(), 11, 1, local=True, mesh=mesh1, RB=32)
    assert got == oracle.sw_score(q, s, B62.scores, 11, 1)


def test_ring_gap_conventions(mesh):
    rng = np.random.default_rng(5)
    q = rng.integers(0, 20, 64).astype(np.uint8)
    s = rng.integers(0, 20, 300).astype(np.uint8)
    for go, ge in [(5, 2), (20, 1)]:
        got = ring_score(q, s, B62.padded(), go, ge, local=True, mesh=mesh)
        assert got == oracle.sw_score(q, s, B62.scores, go, ge)


@pytest.mark.parametrize("m,n", [(41, 179), (30, 30), (65, 500)])
def test_ring_nw_arbitrary_lengths(mesh, m, n):
    """NW capture at any (m, n) — no shard/block alignment required."""
    rng = np.random.default_rng(m + n)
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    got = ring_score(q, s, B62.padded(), 12, 2, local=False, mesh=mesh, RB=32)
    assert got == oracle.nw_score(q, s, B62.scores, 12, 2)


def test_ring_profile_multiple_validation(mesh):
    """m % RB != 0 must raise (not assert: survives python -O)."""
    import jax.numpy as jnp

    from libssa_tpu.parallel.ring import ring_pair_score

    prof = jnp.zeros((33, 32), jnp.int32)
    subj = jnp.zeros((mesh.devices.size * 8,), jnp.int32)
    with pytest.raises(ValueError, match="multiple of RB"):
        ring_pair_score(prof, subj, 12, 1, mesh=mesh, RB=32)


def _ring_check(q, s, local, n_devices, go=11, ge=1, RB=32, matrix=B62):
    got = ring_score(
        q, s, matrix.padded(), go, ge, local=local,
        mesh=make_db_mesh(n_devices), RB=RB,
    )
    want = (oracle.sw_score if local else oracle.nw_score)(
        q, s, matrix.scores, go, ge
    )
    assert got == want, (len(q), len(s), n_devices, local)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize(
    "m,n,D",
    [
        (40, 60, 1),  # single tile, padded
        (300, 200, 2),  # several row blocks, wide shards
        (200, 300, 4),
        (530, 610, 8),  # ragged ends on every device
        (256, 256, 2),  # exact fit
        (257, 513, 4),  # off-by-one over the tile edges
    ],
)
def test_ring_tile_shapes(local, m, n, D):
    """Tile-edge shapes through the scan-tile ring on 1/2/4/8 devices."""
    rng = np.random.default_rng(m * 1000 + n + (1 if local else 0))
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    _ring_check(q, s, local, D, go=10, RB=64)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
@pytest.mark.parametrize("m,n", [(64, 300), (100, 777), (40, 40)])
def test_ring_shapes_four_devices(local, m, n):
    rng = np.random.default_rng(m * 77 + n + (1 if local else 0))
    q = rng.integers(0, 20, m).astype(np.uint8)
    s = rng.integers(0, 20, n).astype(np.uint8)
    _ring_check(q, s, local, 4)


@pytest.mark.parametrize("local", [True, False], ids=["sw", "nw"])
def test_ring_randomized(local):
    rng = np.random.default_rng(7 if local else 8)
    for _ in range(3):
        q = rng.integers(0, 20, int(rng.integers(2, 300))).astype(np.uint8)
        s = rng.integers(0, 20, int(rng.integers(2, 300))).astype(np.uint8)
        _ring_check(q, s, local, 2, go=10, RB=64)


@pytest.mark.parametrize("hi", [4, 15])
def test_ring_nucleotide_codes(hi):
    """Nucleotide-range codes with the top code present, both modes."""
    rng = np.random.default_rng(hi)
    q = rng.integers(0, hi, 230).astype(np.uint8)
    s = rng.integers(0, hi, 410).astype(np.uint8)
    q[0] = s[0] = hi - 1
    for local in (True, False):
        _ring_check(q, s, local, 4, go=10, RB=64)


@pytest.mark.parametrize("RB", [16, 64, 128])
def test_ring_row_block_heights(RB):
    """Row-block height is a schedule knob only: every height is exact."""
    rng = np.random.default_rng(RB)
    q = rng.integers(0, 20, 200).astype(np.uint8)
    s = rng.integers(0, 20, 300).astype(np.uint8)
    for local in (True, False):
        _ring_check(q, s, local, 2, go=10, RB=RB)


def test_ring_gap_only_and_identical():
    """Degenerate pairs crossing shard boundaries."""
    q = np.tile(np.arange(20, dtype=np.uint8), 30)[:300]
    for local in (True, False):
        _ring_check(q, q, local, 4, go=10, RB=64)


def test_ring_f32_window_escape(capsys):
    """Scores past the f32 window escape to the single-device exact path
    with a WARNING (review finding: both ring tile paths compute in f32
    and had no window guard, unlike longpair/tiled)."""
    from libssa_tpu import matrices, oracle
    from libssa_tpu.constants import SymType
    from libssa_tpu.parallel.ring import ring_score
    from libssa_tpu.util.logging import set_output_mode
    from libssa_tpu.constants import OutputMode

    mat = matrices.constant_scoring(2**25, -4, SymType.NUCLEOTIDE)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 40).astype(np.uint8)
    s = np.concatenate([q, rng.integers(0, 4, 20).astype(np.uint8)])
    want = oracle.sw_score(q, s, mat.scores, 10, 2)
    assert want > 2**24
    set_output_mode(OutputMode.WARNING)
    got = ring_score(q, s, mat.padded(), 10, 2, local=True)
    assert int(got) == int(want)
    assert "f32 exactness window" in capsys.readouterr().err

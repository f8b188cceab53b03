"""Tests for the derived geometry tables.

Pins the segment-intersection-derived crossing table against the exact
contents of the reference's hand-written kLinkDescriptorTable
(reference twixtboard.cc:38-144), plus structural invariants.
"""

import numpy as np

from twixt_for_open_spiel_tpu.ops import geometry as geo


# The reference's blocking-link lists (twixtboard.cc:38-144), as
# (dx, dy, direction) with directions canonicalised to the east side
# (the reference already lists them that way).  Parity fixture.
NNE, ENE, ESE, SSE = 0, 1, 2, 3
REFERENCE_BLOCKERS = {
    geo.NNE: {(0, 1, ENE), (-1, 0, ENE), (0, 2, ESE), (0, 1, ESE),
              (-1, 2, ESE), (-1, 1, ESE), (0, 1, SSE), (0, 2, SSE),
              (0, 3, SSE)},
    geo.ENE: {(0, -1, NNE), (1, 0, NNE), (-1, 1, ESE), (0, 1, ESE),
              (1, 1, ESE), (0, 1, SSE), (0, 2, SSE), (1, 1, SSE),
              (1, 2, SSE)},
    geo.ESE: {(0, -1, NNE), (1, -1, NNE), (0, -2, NNE), (1, -2, NNE),
              (-1, -1, ENE), (0, -1, ENE), (1, -1, ENE), (0, 1, SSE),
              (1, 0, SSE)},
    geo.SSE: {(0, -1, NNE), (0, -2, NNE), (0, -3, NNE), (-1, -1, ENE),
              (0, -1, ENE), (-1, -2, ENE), (0, -2, ENE), (-1, 0, ESE),
              (0, -1, ESE)},
    geo.SSW: {(-1, -1, ENE), (-2, -2, ENE), (-2, 0, ESE), (-1, 0, ESE),
              (-2, -1, ESE), (-1, -1, ESE), (-1, 1, SSE), (-1, 0, SSE),
              (-1, -1, SSE)},
    geo.WSW: {(-2, -2, NNE), (-1, -1, NNE), (-3, 0, ESE), (-2, 0, ESE),
              (-1, 0, ESE), (-2, 1, SSE), (-1, 1, SSE), (-2, 0, SSE),
              (-1, 0, SSE)},
    geo.WNW: {(-2, 0, NNE), (-1, 0, NNE), (-2, -1, NNE), (-1, -1, NNE),
              (-3, 0, ENE), (-2, 0, ENE), (-1, 0, ENE), (-2, 2, SSE),
              (-1, 1, SSE)},
    geo.NNW: {(-1, 1, NNE), (-1, 0, NNE), (-1, -1, NNE), (-2, 1, ENE),
              (-1, 1, ENE), (-2, 0, ENE), (-1, 0, ENE), (-2, 2, ESE),
              (-1, 1, ESE)},
}


def test_crossers_match_reference_table():
    for d in range(geo.NUM_DIRS):
        derived = {(int(ox), int(oy), int(d2)) for ox, oy, d2 in geo.CROSSERS[d]}
        assert derived == REFERENCE_BLOCKERS[d], geo.DIR_NAMES[d]


def test_oracle_crossers_match_engine_and_reference():
    """Three-way pin: the test oracle's own crossing table (derived by
    rational intersection-point solving, tests/oracle.py) == the engine's
    (derived by orientation tests, ops/geometry.py) == the hand-transcribed
    reference kLinkDescriptorTable (twixtboard.cc:38-144)."""
    from tests import oracle

    for d in range(geo.NUM_DIRS):
        own = {(ox, oy, d2) for ox, oy, d2 in oracle.CROSSERS[d]}
        engine = {
            (int(ox), int(oy), int(d2)) for ox, oy, d2 in geo.CROSSERS[d]
        }
        assert own == engine == REFERENCE_BLOCKERS[d], geo.DIR_NAMES[d]
    assert [tuple(o) for o in oracle.OFFSETS] == [
        tuple(int(v) for v in row) for row in geo.OFFSETS
    ]


def test_crossers_count_and_canonical_dirs():
    assert geo.CROSSERS.shape == (8, 9, 3)
    assert set(np.unique(geo.CROSSERS[:, :, 2])) <= {0, 1, 2, 3}


def test_crossers_symmetric_under_opp_dir():
    # If ((0,0),d) is crossed by ((ox,oy),d2), then ((ox,oy),d2) is crossed
    # by ((0,0),d) — i.e. by the canonical representation of that link.
    for d in range(geo.NUM_DIRS):
        for ox, oy, d2 in geo.CROSSERS[d]:
            ox, oy, d2 = int(ox), int(oy), int(d2)
            # canonical rep of ((0,0), d) relative to (ox, oy):
            if d < 4:
                want = (-ox, -oy, d)
            else:
                od = geo.opp_dir(d)
                want = (
                    int(geo.OFFSETS[d][0]) - ox,
                    int(geo.OFFSETS[d][1]) - oy,
                    od,
                )
            back = {(int(a), int(b), int(c)) for a, b, c in geo.CROSSERS[d2]}
            assert want in back, (d, ox, oy, d2)


def test_opp_dir():
    assert [geo.opp_dir(d) for d in range(8)] == [4, 5, 6, 7, 0, 1, 2, 3]


def test_offsets_match_compass_doc():
    # reference twixtcell.h:58-68
    assert geo.OFFSETS.tolist() == [
        [1, 2], [2, 1], [2, -1], [1, -2], [-1, -2], [-2, -1], [-2, 1], [-1, 2]
    ]


def test_board_masks_counts():
    for n in (5, 8, 12, 24):
        m = geo.board_masks(n)
        assert m["on_board"].sum() == n * n - 4
        assert m["corner"].sum() == 4
        # reference twixt_test.cc:138: size*(size-2) legal actions per player
        assert m["legal0"].sum() == n * (n - 2)
        assert m["legal1"].sum() == n * (n - 2)
        assert (m["init_flags"] != 0).sum() == 4 * (n - 2)


def test_board_consts_match_numpy_masks():
    # the jnp constant builder must equal the numpy reference
    import numpy as np

    from twixt_for_open_spiel_tpu.ops.state import board_consts

    for n in (5, 8, 24):
        m = geo.board_masks(n)
        c = board_consts(n)
        assert np.array_equal(np.asarray(c["legal"][0]), m["legal0"])
        assert np.array_equal(np.asarray(c["legal"][1]), m["legal1"])
        assert np.array_equal(np.asarray(c["init_color"]), m["init_color"])
        assert np.array_equal(np.asarray(c["init_compid"]), m["init_compid"])
        assert np.array_equal(np.asarray(c["init_flags"]), m["init_flags"])

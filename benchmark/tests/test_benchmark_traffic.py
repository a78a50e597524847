"""The traffic generator is deterministic by seed, for large seeds too."""
import json
import os

import pytest

import benchpaths
from rtvbbench.traffic import Traffic

SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31 + 12345, 3000000001]


def spec(name):
    with open(os.path.join(benchpaths.BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def draw(tr, n=40):
    out = [tr.pose(0.37 * i) for i in range(n)]
    if tr.clicks:
        out += [(tr.click_due(k), tr.click_action(k)) for k in range(n)]
    if tr.character:
        out += [tr.preroll] + [tr.character_move(k) for k in range(400)]
    return out


@pytest.mark.parametrize("name", ["fly", "build", "walk"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(name, seed):
    assert draw(Traffic(spec(name), seed)) == draw(Traffic(spec(name), seed))


@pytest.mark.parametrize("name", ["fly", "build", "walk"])
def test_seeds_differ(name):
    a = draw(Traffic(spec(name), 11))
    b = draw(Traffic(spec(name), 12))
    assert a != b


def test_fly_stays_in_its_box():
    for seed in SEEDS:
        tr = Traffic(spec("fly"), seed)
        for i in range(300):
            (x, y, z), yaw, pitch = tr.pose(0.1 * i)
            assert 0.0 < x < 64.0 and 0.0 < z < 64.0 and y == 18.0
            assert abs(yaw - 1.1) <= 0.3 + 0.25 + 1e-9


def test_walk_turns_about():
    tr = Traffic(spec("walk"), 3)
    ch = tr.character
    moves = [tr.character_move(k) for k in range(2 * (ch["leg_steps"]
                                                      + ch["turn_steps"]))]
    assert moves.count((0.0, 1.0)) == 2 * ch["turn_steps"]
    assert moves[0] == (1.0, 0.0)

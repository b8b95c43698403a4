"""K8, CoreSLAM's Monte-Carlo search (``csrc/mc_search.cu``), held on the
CPU.

The kernel runs only on a card.  Here: ``score.best_of`` takes the plain
path for CPU tensors and counts no launch; its key is in the launch
registry; ``monte_carlo_search`` calls ``best_of`` through the module's
name (the benchmark's ``half_search`` plant wraps it there); the wrapper's
input checks; and the cases of ``ops.score_cases`` (a planted tie, every
candidate out of the map, no valid beam, B = 1 / 2,000 / 4,001 at
coreslam_sim256's size) give the pose and sum they must through the plain
path.  The same cases, and each of 4,001 candidates alone, hold K8 against
the plain path bit for bit on a card and skip without one
(``chip_smoke.py`` phase 39 runs them, and a whole job, on the card).
"""
import pytest
import torch

from slamnet_tpu_torch.ops import _build, score, score_cases


@pytest.fixture(scope="module")
def cpu_world():
    return score_cases.world(torch.device("cpu"))


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return score_cases.world(torch.device("cuda"))


def test_k8_is_a_registered_kernel():
    assert "K8_search" in _build.KERNELS
    assert "K8_search" in _build.kernel_launches()


@pytest.mark.parametrize("case", score_cases.CASES)
def test_the_plain_path_gives_each_case_on_the_cpu(cpu_world, case):
    """``best_of`` on CPU tensors is ``best_of_plain`` bit for bit, gives
    the case's winner and sum, and counts no launch."""
    c0 = _build.kernel_launches()
    score_cases.run(case, cpu_world)
    assert _build.kernel_launches() == c0


def test_monte_carlo_search_calls_best_of_by_its_module_name(cpu_world):
    """A stand-in for ``score.best_of`` receives the candidates that
    ``sample_candidates`` draws, and its answer is the search's."""
    w = cpu_world
    pose = torch.tensor([20.0, 20.0, 0.5])
    calls = []

    def stub(cands, *args):
        calls.append((cands, args))
        return cands[7], torch.tensor(11, dtype=torch.int32)

    draw = score.sample_candidates(pose, 0.1, 0.2, 64,
                                   torch.Generator().manual_seed(5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(score, "best_of", stub)
        got, best = score.monte_carlo_search(
            w.hole, w.size, w.scale, w.points, w.valid, pose, 0.1, 0.2, 64,
            torch.Generator().manual_seed(5))
    assert len(calls) == 1 and torch.equal(calls[0][0], draw)
    assert calls[0][1] == (w.hole, w.size, w.scale, w.points, w.valid)
    assert torch.equal(got, draw[7]) and int(best) == 11


def test_the_kernel_inputs_are_checked(cpu_world):
    cands, hole, size, _, pts, val = score_cases.CASES["b4001"](cpu_world)[0]
    assert score.check_search_inputs(cands, hole, size, pts, val) == (4001,
                                                                      400)
    bad = {"cands": ((cands.double(), hole, size, pts, val),
                     (cands[:, :2].contiguous(), hole, size, pts, val),
                     (cands[:0], hole, size, pts, val),
                     (cands.t().contiguous().t(), hole, size, pts, val)),
           "hole_map": ((cands, hole.long(), size, pts, val),
                        (cands, hole[:-1], size, pts, val),
                        (cands, hole.to("meta"), size, pts, val)),
           "points": ((cands, hole, size, pts.half(), val),
                      (cands, hole, size, pts.to("meta"), val)),
           "valid": ((cands, hole, size, pts, val.int()),
                     (cands, hole, size, pts, val[:-1]))}
    for name, calls in bad.items():
        for args in calls:
            with pytest.raises(ValueError, match=f"K8 search {name}"):
                score.check_search_inputs(*args)


@pytest.mark.card
@pytest.mark.parametrize("case", score_cases.CASES)
def test_k8_equals_the_plain_path_on_the_card(card_world, case):
    """K8 against ``best_of_plain`` on the card, bit for bit, with the
    case's winner and sum and one launch."""
    score_cases.run(case, card_world)


@pytest.mark.card
def test_k8_scores_each_candidate_as_the_plain_path_on_the_card(card_world):
    """Each of the 4,001 candidates alone through K8 (B = 1): its effective
    sum is ``score_candidates``'."""
    args = score_cases.CASES["b4001"](card_world)[0]
    assert score_cases.each_candidate(*args) == 0

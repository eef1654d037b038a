"""The records a run keeps for its comparison: the first of the longest and
k others drawn from the seed; the rest drop their tensors as the window goes."""
from perfbench.harness.check import Sample


def _run(seed, lengths, k=2):
    s = Sample(k, seed, ("heavy",))
    recs = [{"L": L, "i": i, "heavy": object()} for i, L in enumerate(lengths)]
    for r in recs:
        s.offer(r)
    return s, recs


def test_keeps_the_longest_and_k_others():
    s, recs = _run(11, [256, 384, 768, 256, 768, 384, 256, 768, 384])
    kept = s.records()
    assert kept[0]["i"] == 2 and len(kept) == 3
    assert all("heavy" in r for r in kept)
    assert sum("heavy" in r for r in recs) == 3


def test_drawn_from_the_seed():
    lengths = [256, 384, 768] * 20
    picks = {tuple(r["i"] for r in _run(seed, lengths)[0].records()) for seed in range(8)}
    assert len(picks) > 1
    a = [r["i"] for r in _run(5, lengths)[0].records()]
    b = [r["i"] for r in _run(5, lengths)[0].records()]
    assert a == b


def test_fewer_records_than_k():
    s, recs = _run(1, [96], k=3)
    assert [r["i"] for r in s.records()] == [0]

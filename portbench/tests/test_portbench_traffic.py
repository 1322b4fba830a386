"""The traffic generator: the same seed gives the same corpus, and every
seed the same set of sizes (so the same work)."""

import numpy as np
import torch

from portbench import traffic
from portbench.harness import Bench


def corpus(seed, cell="conformer-train"):
    t = Bench().cell(cell)["traffic"]
    t = dict(t, groups=[dict(g, count=5) for g in t["groups"]])
    return traffic.generate(t, list("abcdefgh"), seed, torch.device("cpu"),
                            words=cell == "ds2-train")


def test_repeats_for_a_seed():
    a, b = corpus(2**31 + 7), corpus(2**31 + 7)
    assert [u.text for u in a] == [u.text for u in b]
    assert all(np.array_equal(x.samples, y.samples) for x, y in zip(a, b))


def test_every_seed_the_same_sizes():
    for cell in ("conformer-train", "ds2-train"):
        a, b = corpus(1, cell), corpus(2, cell)
        assert sorted(len(u.samples) for u in a) == sorted(len(u.samples) for u in b)
        assert sorted(len(u.text) for u in a) == sorted(len(u.text) for u in b)
        assert [len(u.samples) for u in a] != [len(u.samples) for u in b]


def test_durations_stay_in_their_groups():
    t = Bench().cell("conformer-train")["traffic"]
    durs = traffic.durations(t)
    i = 0
    for g in t["groups"]:
        chunk = durs[i:i + g["count"]]
        assert g["min_s"] <= min(chunk) and max(chunk) <= g["max_s"]
        i += g["count"]
    assert abs(np.mean(durs) - 4.5) < 0.1  # AISHELL-1's train set averages 4.50 s


def test_conformer_batches_repeat_for_a_seed(toy):
    """The Conformer's batches, made in memory: the same seed gives the same
    batches, another seed the same shapes and the same audio an epoch,
    dealt out in another order."""
    from portbench.harness import Bench as TreeBench

    bench = TreeBench(toy)
    cell = bench.cell("toy-conformer-train")
    config = bench.config(cell["config"])
    fam = bench.family("conformer")
    cpu = torch.device("cpu")
    a, b = (fam.corpus(config, cell, 2**31 + 9, cpu) for _ in range(2))
    c = fam.corpus(config, cell, 3, cpu)
    for x, y in zip(a["batches"], b["batches"]):
        for key in x:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)
    shapes = [sorted(x["wavs"].shape for x in corpus["batches"]) for corpus in (a, c)]
    assert shapes[0] == shapes[1]
    assert abs(sum(a["audio_s"]) - sum(c["audio_s"])) < 1e-6
    assert a["audio_s"] != c["audio_s"]

"""RAFT-Stereo's test-mode refinement replayed from a CUDA graph
(``models/graphs.py``) on the card: the replay against the eager forward bit
for bit at the stream's and the DKT teachers' shapes and with ``alt_cuda``,
weights updated in place, two shapes in turn, two models sharing their input
buffers, outputs that the caller keeps, and the K1 and K3 launch counters. Every test is marked ``card`` and skips
without a CUDA card; this file imports no JAX, so that it runs where there
is none:

    python -m pytest tests/test_torch_raft_graph.py -q --noconftest
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from dkt_stereo_tpu_torch.dkt.ema import ema_update
from dkt_stereo_tpu_torch.models.registry import create_model
from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup

CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "raft_stereo"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100")
    return torch.device("cuda", 0)


def _model(card, name: str, iters: int, seed: int = 0):
    """The shipped config's test-mode model with seeded weights, the flow
    head's last conv x0.02 (the benchmark's frames: disparities that stay
    within the image)."""
    config = json.loads((CONFIGS / name).read_text())
    model = create_model(config, iters=iters, device=card, seed=seed)
    with torch.no_grad():
        for p in model.update_block.flow_head.conv2.parameters():
            p.mul_(0.02)
    return model


def _pair(card, shape, seed: int):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(255 * torch.rand((*shape, 3), generator=g, device=card) for _ in range(2))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _replays(model) -> list:
    """A list that grows by one at each replay of the model's graphs."""
    seen = []
    for graph in model._graphs.entries.values():
        if graph is not None and not hasattr(graph, "counted"):
            replay, graph.counted = graph.replay, True
            graph.replay = lambda r=replay: seen.append(1) or r()
    return seen


def _spy(model):
    """The model's eager calls of its refinement, each as (inputs,
    outputs): the inputs as the graph takes them (fmap, the GRUs' states,
    their context inputs)."""
    calls = []
    refine = model._refine

    def spy(fmap, net, zqr, *rest):
        out = refine(fmap, net, zqr, *rest)
        if not torch.cuda.is_current_stream_capturing():
            calls.append(((fmap, *net, *zqr), out))
        return out

    model._refine = spy
    return calls


@pytest.mark.card
@pytest.mark.parametrize("config, shape, counter, mode", [
    ("pallas.json", (1, 736, 1280), corr_lookup, torch.inference_mode),  # the stream's frames
    ("train.json", (8, 320, 720), corr_lookup, torch.no_grad),  # the DKT step's teachers
    ("alt_pallas.json", (1, 480, 640), corr_lookup_alt, torch.inference_mode),  # K3
])
def test_replay_matches_eager_bit_for_bit(card, config, shape, counter, mode):
    """Eager, then captured and replayed, then replayed: the graph given
    the eager forward's encoder outputs returns its bits; the kernel
    counter rises by the iterations in every forward and replay; a
    returned disparity stays as it was through the next replays. (The
    fused encoder, K2, sums its statistics in no fixed order, so two
    forwards of ``pallas.json`` differ before the refinement.)"""
    model = _model(card, config, iters=32)
    calls = _spy(model)
    x1, x2 = _pair(card, shape, 1)
    outs, launches = [], []
    with mode():
        for _ in range(3):
            n = counter.launches
            outs.append(model(x1, x2))
            launches.append(counter.launches - n)
        kept = [o.clone() for o in outs[1]]
        seen = _replays(model)
        other = model(*_pair(card, shape, 2))
        (graph,) = [g for g in model._graphs.entries.values() if g is not None]
        (inputs, want), = calls
        n = counter.launches
        got = graph(inputs)
        launches.append(counter.launches - n)
    torch.cuda.synchronize(card)
    assert launches == [32] * 4 and len(seen) == 2
    assert all(torch.isfinite(o).all() for o in want)
    assert _equal(got, want)
    assert _equal(outs[1], kept) and not torch.equal(outs[1][1], other[1])
    if config == "train.json":  # no K2: the whole forwards agree
        assert _equal(outs[0], outs[1]) and _equal(outs[0], outs[2])


@pytest.mark.card
def test_replay_reads_weights_updated_in_place(card):
    """An EMA update and a ``load_state_dict`` reach the next replay; moving
    the weights to other memory drops the module's graphs."""
    model = _model(card, "train.json", iters=8)
    student = _model(card, "train.json", iters=8, seed=1)
    x1, x2 = _pair(card, (2, 320, 720), 3)
    with torch.no_grad():
        first = model(x1, x2)
        model(x1, x2)
        seen = _replays(model)
        for change in (lambda: ema_update(model, student, 0.5),
                       lambda: model.load_state_dict(student.state_dict())):
            change()
            n = len(seen)
            got = model(x1, x2)
            assert len(seen) == n + 1
            assert _equal(got, copy.deepcopy(model)(x1, x2))
            assert not torch.equal(got[1], first[1])
        keep = [p.detach() for p in model.parameters()]  # no new weight at an old address
        model.cpu().to(card)
        n = len(seen)
        model(x1, x2)
        assert len(seen) == n
        assert list(model._graphs.entries.values()) == [None]
        del keep


@pytest.mark.card
def test_two_shapes_in_turn_keep_their_graphs(card):
    """Batches of two sizes in turn: one graph each, each replay the eager
    forward's bits."""
    model = _model(card, "train.json", iters=4)
    pairs = [_pair(card, (2, 320, 640), 4), _pair(card, (2, 384, 704), 5)]
    with torch.no_grad():
        want = [copy.deepcopy(model)(*p) for p in pairs]
        for _ in range(3):
            for p, w in zip(pairs, want):
                assert _equal(model(*p), w)
    assert sum(g is not None for g in model._graphs.entries.values()) == 2


@pytest.mark.card
def test_two_modules_share_their_input_buffers(card):
    """Two models with inputs of one shape in turn (a DKT step's two
    teachers): their graphs read one set of input buffers, and each replay
    gives its own model's eager bits."""
    models = [_model(card, "train.json", iters=4, seed=s) for s in (0, 1)]
    x1, x2 = _pair(card, (2, 320, 640), 7)
    with torch.no_grad():
        want = [copy.deepcopy(m)(x1, x2) for m in models]
        for _ in range(3):
            for m, w in zip(models, want):
                assert _equal(m(x1, x2), w)
    (a,), (b,) = (list(m._graphs.entries.values()) for m in models)
    assert a.inputs is b.inputs and not _equal(want[0], want[1])


@pytest.mark.card
def test_grad_or_train_mode_stays_eager(card):
    """With gradients on, or in train mode, no graph is captured."""
    model = _model(card, "pallas.json", iters=2)
    train = create_model(json.loads((CONFIGS / "pallas.json").read_text()), iters=2,
                         device=card, seed=0, test_mode=False)
    x1, x2 = _pair(card, (1, 256, 512), 6)
    for _ in range(3):
        model(x1, x2)
        train(x1, x2)
    assert not model._graphs.entries and not train._graphs.entries

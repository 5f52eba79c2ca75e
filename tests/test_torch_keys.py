"""Memoised, interned keys (``repro_torch.core.tdg.keyed_signature``,
``GraphReplay``'s keying) against the plain computations they memoise.

Over a table of buffer dicts and mutations, the fast path's buffer
signature must equal ``plain_buffers_signature``'s and its graph key the
``(str(spec), _graph_key(leaves, donated))`` of ``pytree.tree_flatten``;
equal keys must be one object; every mutation must miss. Then a
``RegionServer`` over a tiny 40-layer glm4 and two tenants counts its key
lookups: misses only on the first step of a structure, hits after, the
``hit`` span attribute agreeing, coalescing and a member's migration when
its cache tree gains a layer as before.
"""
import collections
import gc
import pickle

import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.core import TDG, spans, tdg  # noqa: E402
from repro_torch.core.lower import GraphReplay, _graph_key  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import RegionServer  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402


class _OnCard(torch.Tensor):
    """A CPU tensor that a graph replay keys as a CUDA one (by shape, dtype
    and device; a donated one by address and strides)."""

    is_cuda = True


def _card(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_OnCard)


def _caches(layers, batch=2, card=True):
    make = _card if card else torch.zeros
    return [{"attn": {"k": make(batch, 8, 1, 4), "v": make(batch, 8, 1, 4),
                      "pos": make(batch, 8)}} for _ in range(layers)]


def _net(width=4):
    return nn.Sequential(nn.Linear(4, width), nn.ReLU(), nn.Linear(width, 4))


# Each case yields (buffers, mutated): ``mutated`` marks a state right after
# a change that the signature memo cannot see coming, which must miss.

def _params_module():
    net = _net()
    yield {"params": net, "x": _card(2, 3)}, False
    yield {"params": net, "x": _card(2, 3)}, False
    yield {"params": _net(), "x": _card(2, 3)}, True      # another module, same shapes
    yield {"params": _net(8), "x": _card(2, 3)}, True


def _nested_caches():
    for batch in (2, 2, 3, 2):
        yield {"tokens": _card(batch, 1, dtype=torch.int32), "caches": _caches(40, batch)}, False


def _small_cpu_values():
    for n in (3, 4, 3):
        yield {"x": _card(2, 3), "n": torch.tensor(n), "scale": 0.5}, False


def _donated():
    caches = _caches(3)
    yield {"caches": caches, "x": _card(2)}, False
    yield {"caches": caches, "x": _card(2)}, False
    yield {"caches": _caches(3), "x": _card(2)}, False
    yield {"caches": [{"attn": {**c["attn"], "k": c["attn"]["k"].transpose(1, 2)}}
                      for c in caches], "x": _card(2)}, False


def _setattr_param():
    net = _net()
    yield {"params": net, "x": _card(2)}, False
    net[0].weight = nn.Parameter(torch.ones(4, 4))        # same shape: same signature
    yield {"params": net, "x": _card(2)}, True
    net[0].weight = nn.Parameter(torch.ones(4, 5))
    yield {"params": net, "x": _card(2)}, True


def _to_bf16():
    net = _net()
    yield {"params": net, "x": _card(2)}, False
    net.to(torch.bfloat16)
    yield {"params": net, "x": _card(2)}, True
    yield {"params": net, "x": _card(2)}, False


def _submodule_swapped():
    net = _net()
    yield {"params": net, "x": _card(2)}, False
    net[2] = nn.Linear(4, 4)
    yield {"params": net, "x": _card(2)}, True
    net[2] = nn.Linear(4, 4, bias=False)
    yield {"params": net, "x": _card(2)}, True


def _reshaped_through_data():
    net = _net()
    yield {"params": net, "x": _card(2)}, False
    net[0].weight.data = torch.zeros(2, 8)
    yield {"params": net, "x": _card(2)}, True
    del net[0].bias                                       # no hook sees a deletion
    yield {"params": net, "x": _card(2)}, True


def _cache_gains_layer():
    caches = _caches(40)
    yield {"caches": caches}, False
    caches = caches + _caches(1)
    yield {"caches": caches}, True


def _module_freed():
    net = _net()
    old = id(net)
    yield {"params": net, "x": _card(2)}, False
    del net
    gc.collect()
    for _ in range(64):           # the freed slot is usually the next one taken
        net = _net(8)
        if id(net) == old:
            break
    yield {"params": net, "x": _card(2)}, True


def _containers():
    a, b = _card(2), _card(3)
    for tree in ([a, b], (a, b), [[], a], [a, []], {"a": a, "b": b}, {"b": b, "a": a}, [a, b]):
        yield {"c": tree, "x": _card(1)}, False


def _not_plain():
    pair = collections.namedtuple("pair", "a b")
    yield {"p": pair(_card(2), _card(3)), "d": {1: _card(2)}}, True
    yield {"p": pair(_card(2), _card(3)), "d": {1: _card(2)}}, True
    yield {"p": collections.OrderedDict(a=_card(2))}, True


CASES = {
    "params_module": (_params_module, ()),
    "nested_40_layer_caches": (_nested_caches, ()),
    "small_cpu_tensors_by_value": (_small_cpu_values, ()),
    "donated_by_address_and_strides": (_donated, ("caches",)),
    "parameter_replaced_by_setattr": (_setattr_param, ()),
    "module_to_bfloat16": (_to_bf16, ()),
    "submodule_swapped": (_submodule_swapped, ()),
    "parameter_reshaped_through_data": (_reshaped_through_data, ()),
    "cache_tree_gains_a_layer": (_cache_gains_layer, ()),
    "module_freed_and_reallocated": (_module_freed, ()),
    "non_plain_trees_fall_back": (_not_plain, ()),
    "lists_tuples_and_key_order": (_containers, ()),
}


def _plain_graph_key(replay, buffers):
    leaves, spec = pytree.tree_flatten(buffers)
    return (str(spec), _graph_key(leaves, replay._donated_leaves(buffers)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_keys_split_buffer_dicts_as_the_plain_path_does(case):
    states, donate = CASES[case]
    replay = GraphReplay(lambda b: b, case, donate=donate)
    sigs, plain_sigs, keys, plain_keys = [], [], [], []
    for buffers, mutated in states():
        sig, hit = tdg.keyed_signature(buffers)
        assert sig == tdg.plain_buffers_signature(buffers)
        assert sig is tdg.buffers_signature(buffers)
        if mutated:
            assert not hit, "a mutation hit the memo"
        leaves, spec, _, key, _ = replay._key(buffers)
        assert tdg.same_leaves(leaves, pytree.tree_leaves(buffers))
        assert spec == pytree.tree_flatten(buffers)[1]
        assert key == _plain_graph_key(replay, buffers)
        sigs.append(sig), plain_sigs.append(tdg.plain_buffers_signature(buffers))
        keys.append(key), plain_keys.append(_plain_graph_key(replay, buffers))
        del buffers, leaves         # what a state held may be freed by the next one
    for new, old in ((sigs, plain_sigs), (keys, plain_keys)):
        for i in range(len(new)):
            for j in range(len(new)):
                assert (new[i] is new[j]) == (old[i] == old[j]), (i, j)
    # A known structure is a hit, once what it mutated is learned.
    again = list(states())[-1][0]
    tdg.keyed_signature(again)
    assert tdg.keyed_signature(again)[1] is (case != "non_plain_trees_fall_back")


def test_canonical_keys_hash_once_and_pickle_as_tuples():
    value = (("a", (1, 2)), "torch.float32", "canonical keys pickle as tuples")
    canon, known = tdg.intern_key(value)
    assert not known and isinstance(canon, tdg.Canonical) and canon == value and hash(canon) == hash(value)
    assert tdg.intern_key(tuple(value)) == (canon, True)
    assert tdg.intern_key(value)[0] is canon
    back = pickle.loads(pickle.dumps(canon))
    assert type(back) is tuple and back == value


# ---------------------------------------------------------------- the server

MAX_LEN = 16


@pytest.fixture(scope="module")
def glm4():
    cfg = reduced(get_config("glm4-9b"), num_layers=40)
    params = M.init_params(cfg, torch.Generator().manual_seed(3))
    return cfg, params


def _decode_buffers(cfg, params, seed):
    gen = torch.Generator().manual_seed(seed)
    return {"params": params,
            "tokens": torch.randint(2, cfg.vocab_size, (2, 1), generator=gen, dtype=torch.int32),
            "pos": torch.zeros(2, dtype=torch.int32),
            "caches": M.init_caches(cfg, 2, MAX_LEN, "cpu")}


def _spans_hits(name):
    return [r["args"]["hit"] for r in spans.snapshot() if r["name"] == name]


def test_server_counts_key_misses_on_a_structures_first_step_only(glm4):
    cfg, params = glm4
    decode = make_serve_step(cfg)
    server = RegionServer(max_batch=2, max_wait_ms=0, continuous=True, autostart=False,
                          adaptive=False)
    for i in range(2):
        g = TDG(f"keys[{i}]")
        g.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                   outs=["next", "caches"], name="decode")
        server.register_tenant(f"t{i}", g, outputs=("next", "caches"))
    spans.enable()
    try:
        steps = 3
        futs = [server.submit_stream(f"t{i}", _decode_buffers(cfg, params, i), steps=steps)
                for i in range(2)]
        server.start()
        outs = [f.result(120) for f in futs]
        keys = server.stats()["keys"]
        submits, replays = _spans_hits("submit.key"), _spans_hits("replay.key")
        assert submits == [0, 1] and replays == [0] + [1] * (steps - 1)
        settles = 2 * (steps - 1)             # survivors re-keyed after each step but the last
        assert keys["misses"] == 2 and keys["hits"] == 1 + (steps - 1) + settles
        assert keys["entries"] >= 2

        # Then one submission a step per tenant, as a closed-loop client makes:
        # every key a hit, both in the class the streams formed.
        with torch.no_grad():
            bufs = [{**_decode_buffers(cfg, params, i), "tokens": o["next"][:, None],
                     "pos": torch.full((2,), steps, dtype=torch.int32), "caches": o["caches"]}
                    for i, o in enumerate(outs)]
        for _ in range(2):
            outs = [f.result(120) for f in server.submit_many(
                [(f"t{i}", b) for i, b in enumerate(bufs)])]
            bufs = [{**b, "tokens": o["next"][:, None], "pos": b["pos"] + 1,
                     "caches": o["caches"]} for b, o in zip(bufs, outs)]
        after = server.stats()["keys"]
        assert after["misses"] == 2 and after["hits"] == keys["hits"] + 2 * 3
        assert _spans_hits("submit.key")[2:] == [1] * 4
        assert _spans_hits("replay.key")[steps:] == [1, 1]
    finally:
        server.close()
        spans.disable()
    trace = [(r["class_id"], r["occupancy"], r["coalesced"])
             for r in server.metrics.trace.snapshot()]
    assert trace == [(0, 2, True)] * (steps + 2)
    assert server.stats()["metrics"]["batch_fallbacks"] == 0


def _grow(caches):
    return caches + [{"k": caches[-1]["k"] * 2}]


def test_a_member_whose_cache_tree_grows_migrates_and_misses():
    """A member whose outputs add a layer to its cache tree leaves its class
    for the one that matches; each new structure misses once: its first
    member's re-key and its first replay, not the second member's re-key."""
    server = RegionServer(max_batch=2, continuous=True, autostart=False, adaptive=False)
    futs = []
    for i in range(2):
        g = TDG(f"grow[{i}]")
        g.add_task(_grow, ins=["caches"], outs=["caches"])
        server.register_tenant(f"g{i}", g)
        futs.append(server.submit_stream(f"g{i}", {"caches": [{"k": torch.full((2, 3), i + 1.0)}]},
                                         steps=3))
    spans.enable()
    try:
        server.start()
        outs = [f.result(120) for f in futs]
    finally:
        server.close()
        spans.disable()
    assert [len(o["caches"]) for o in outs] == [4, 4]
    assert [float(o["caches"][-1]["k"][0, 0]) for o in outs] == [8.0, 16.0]
    assert [(r["class_id"], r["occupancy"], r["leaves"]) for r in server.metrics.trace.snapshot()] \
        == [(0, 2, 2), (1, 2, 2), (2, 2, 2)]
    keys = server.stats()["keys"]
    assert (keys["misses"], keys["hits"]) == (1 + 3 + 2, 1 + 2)

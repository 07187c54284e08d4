"""The port's copy of the paged KV allocator (``repro_torch.serve.kv_pool``)
against ``repro.serve.kv_pool``.

Both pools are driven by the same random sequences of admit /
ensure_writable / register_prompt / truncate / swap_out / swap_in /
lane_release / cap_window / flush_tree.  After every operation they must have
returned the same actions (or raised the same exhaustion with the same
actions), and hold the same page tables, refcounts, free pages, tree pages
and stats; ``check()`` must pass on both.
"""
import numpy as np
import pytest

from repro.serve import kv_pool as jpool

from repro_torch.serve import kv_pool as tpool


def _state(pool):
    return (pool.table.tolist(), pool.ref.tolist(), list(pool._free),
            sorted(pool._node_of_page), dict(pool.stats),
            pool.evictable_pages)


def _call(mod, pool, name, args):
    try:
        out = getattr(pool, name)(*args)
    except mod.PoolExhaustedError as e:
        return ("exhausted", [tuple(a) for a in e.actions])
    if name in ("admit", "swap_out", "swap_in"):
        first, actions = out
        return ("ok", first, [tuple(a) for a in actions])
    return ("ok", None if out is None else [tuple(a) for a in out])


class _PoolPair:
    """Chooses valid operations from the (shared) pool state and applies
    each to both pools."""

    def __init__(self, seed, lanes=3, mp=4, ps=4, n_pages=None):
        self.rng = np.random.default_rng(seed)
        n = n_pages or mp + 2 + int(self.rng.integers(0, lanes * mp))
        self.pools = (tpool.PagedKVPool(n, ps, lanes, mp),
                      jpool.PagedKVPool(n, ps, lanes, mp))
        self.lanes, self.mp, self.ps = lanes, mp, ps
        self.lane = [None] * lanes        # {"prompt", "pos", "reg"} or None
        self.swapped: list[tuple[dict, list[int]]] = []
        bank = [self.rng.integers(2, 9, int(self.rng.integers(3, 12))).tolist()
                for _ in range(3)]
        self.prompts = [b + self.rng.integers(2, 9, int(self.rng.integers(
            1, 6))).tolist() for b in bank for _ in range(3)]

    def apply(self, name, *args):
        mine = _call(tpool, self.pools[0], name, args)
        ref = _call(jpool, self.pools[1], name, args)
        assert mine == ref, (name, args, mine, ref)
        assert _state(self.pools[0]) == _state(self.pools[1]), (name, args)
        for pool in self.pools:
            pool.check()
        return mine

    def step(self):
        rng, cap = self.rng, self.mp * self.ps
        free = [l for l in range(self.lanes) if self.lane[l] is None]
        busy = [l for l in range(self.lanes) if self.lane[l] is not None]
        r = rng.random()
        if free and self.swapped and r < 0.15:
            lane = free[0]
            req, js = self.swapped.pop(0)
            if self.apply("swap_in", lane, js)[0] == "ok":
                self.lane[lane] = req
            else:
                self.swapped.insert(0, (req, js))
        elif free and r < 0.35:
            lane = int(rng.choice(free))
            prompt = self.prompts[int(rng.integers(len(self.prompts)))]
            res = self.apply("admit", lane, prompt)
            self.lane[lane] = {"prompt": prompt, "pos": res[1], "reg": False}
        elif busy and r < 0.75:
            lane = int(rng.choice(busy))
            st = self.lane[lane]
            room = cap - st["pos"]
            if room <= 1:
                self.apply("lane_release", lane)
                self.lane[lane] = None
                return
            pending = len(st["prompt"]) - st["pos"]
            count = int(rng.integers(1, min(room - 1, 6) + 1))
            if pending > 0:
                count = min(count, pending)
            if self.apply("ensure_writable", lane, st["pos"], count)[0] != "ok":
                return
            st["pos"] += count
            if st["pos"] >= len(st["prompt"]) and not st["reg"]:
                self.apply("register_prompt", lane, st["prompt"])
                st["reg"] = True
        elif busy and r < 0.82:
            lane = int(rng.choice(busy))
            st = self.lane[lane]
            if st["reg"] and st["pos"] > len(st["prompt"]) + 1:
                keep = int(rng.integers(len(st["prompt"]) + 1, st["pos"]))
                self.apply("truncate", lane, keep, st["pos"])
                st["pos"] = keep
        elif busy and r < 0.9:
            lane = int(rng.choice(busy))
            res = self.apply("swap_out", lane)
            self.swapped.append((self.lane[lane], [j for j, _ in res[1]]))
            self.lane[lane] = None
        elif busy and r < 0.95:
            lane = int(rng.choice(busy))
            if self.lane[lane]["reg"]:
                self.apply("cap_window", lane, self.lane[lane]["pos"],
                           2 * self.ps)
        elif busy and r < 0.98:
            lane = int(rng.choice(busy))
            self.apply("lane_release", lane)
            self.lane[lane] = None
        else:
            self.apply("flush_tree")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_match_reference(seed):
    d = _PoolPair(seed)
    for _ in range(400):
        d.step()
    stats = d.pools[0].stats
    assert stats["prefix_hits"] > 0          # the sequences did share


def test_tight_pool_exhaustion_matches_reference():
    """A pool of one lane's worst case + 2: exhaustion, eviction and the
    transactional swap-in roll back identically."""
    d = _PoolPair(7, lanes=3, mp=4, ps=4, n_pages=6)
    seen = set()
    for _ in range(400):
        d.step()
    for pool in d.pools:
        seen.add(pool.stats["evictions"] > 0)
    assert seen == {True}


def test_directed_share_cow_and_swap():
    """The reference's basic scenario step by step: full pages shared, a
    partial page copied on write, a swap round trip rebinding pages."""
    d = _PoolPair(0, lanes=3, mp=4, ps=4, n_pages=20)
    prompt = list(range(100, 110))                 # 2.5 pages of 4
    d.apply("admit", 0, prompt)
    d.apply("ensure_writable", 0, 0, len(prompt))
    d.apply("register_prompt", 0, prompt)
    shared = d.apply("admit", 1, prompt[:9] + [7, 7])
    assert shared[1] == 9 and ("copy",) == tuple(a[0] for a in shared[2])[:1]
    out = d.apply("swap_out", 1)
    assert [j for j, _ in out[1]] == [0, 1, 2]
    back = d.apply("swap_in", 2, [0, 1, 2])
    assert len(back[1]) == 3
    d.apply("lane_release", 0)
    d.apply("lane_release", 2)
    d.apply("flush_tree")
    assert d.pools[0].free_pages == d.pools[0].n - 1


def test_exhaustion_error_is_the_ports_own_type():
    pool = tpool.PagedKVPool(6, 4, 2, 4)
    pool.ensure_writable(0, 0, 16)
    with pytest.raises(tpool.PoolExhaustedError) as e:
        pool.ensure_writable(1, 0, 8)
    assert isinstance(e.value, RuntimeError) and not isinstance(
        e.value, jpool.PoolExhaustedError)
    pool.check()

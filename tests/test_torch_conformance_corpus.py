"""The port's corpus generators (``conformance/corpus.py``) against the JAX
package's: every ``random.Random`` draw in the same order, so a seed gives
the same records byte for byte. A trace step is the port's
``packed_expand`` on a one-lane batch and the chosen candidate; the JAX
step is ``packed_step``.

The JAX generators step their models eagerly (abd takes about 2 s a step
on the CPU), so their walks here are short. The seed corpus
(``examples/conformance_corpus.jsonl``, written by the JAX generator) is
regenerated by the port, line for line.
"""

import os
import random

import pytest

from stateright_tpu.conformance import corpus as jax_corpus
from stateright_tpu.service.zoo import default_zoo as jax_default_zoo
from stateright_tpu_torch.conformance import (
    encode_record,
    generate_corpus,
    mutate_trace,
    random_walk_trace,
)
from stateright_tpu_torch.service import default_zoo

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_CORPUS = os.path.join(REPO_DIR, "examples", "conformance_corpus.jsonl")

# The seed corpus's generator settings.
SEED_CORPUS_SEED = 7
SEED_CORPUS_SHAPES = (
    ("register", "linearizability", 2, 2),
    ("register", "sequential", 2, 2),
    ("register", "linearizability", 3, 2),
    ("vec", "linearizability", 2, 2),
)

# (zoo name, args, walks, steps): two-thread increment_lock reaches its
# terminal state after 8 steps, where the generator stops before drawing.
WALKS = [("increment_lock", {}, 2, 16), ("increment_lock", {"threads": 2}, 2, 12),
         ("2pc", {}, 3, 8), ("abd", {}, 1, 4)]


def test_generate_corpus_reproduces_the_seed_corpus():
    with open(SEED_CORPUS, encoding="utf-8") as f:
        want = [ln.rstrip("\n") for ln in f if ln.strip()]
    zoo = default_zoo()
    specs = [(name, {}, zoo[name]()) for name in ("increment_lock", "2pc")]
    got = generate_corpus(SEED_CORPUS_SEED, specs, histories=24,
                          history_shapes=SEED_CORPUS_SHAPES)
    assert [encode_record(r) for r in got] == want


@pytest.mark.parametrize("name,args,walks,steps", WALKS,
                         ids=["increment_lock", "increment_lock2", "2pc", "abd"])
def test_walks_and_mutations_match_jax(name, args, walks, steps):
    """Seeded walks and their divergent twins: the same records as JAX's,
    and the two generators leave their ``Random`` in the same state."""
    model, jax_model = default_zoo()[name](**args), jax_default_zoo()[name](**args)
    a, b = random.Random(11), random.Random(11)
    for i in range(walks):
        kw = dict(rec_id=f"{name}-{i}", model_name=name, model_args=args)
        got = random_walk_trace(model, a, steps, **kw)
        want = jax_corpus.random_walk_trace(jax_model, b, steps, **kw)
        assert got == want
        assert mutate_trace(model, a, got) == jax_corpus.mutate_trace(jax_model, b, want)
    assert a.random() == b.random()
    if args:
        assert len(got["actions"]) == 8  # the walk ended at the terminal state


def test_generate_corpus_matches_jax():
    """A whole small corpus over two models: the same records, in order."""
    zoo, jax_zoo = default_zoo(), jax_default_zoo()
    names = ("increment_lock", "2pc")
    got = generate_corpus(3, [(n, {}, zoo[n]()) for n in names],
                          traces_per_model=2, mutated_per_model=1, trace_steps=6,
                          histories=9)
    want = jax_corpus.generate_corpus(3, [(n, {}, jax_zoo[n]()) for n in names],
                                      traces_per_model=2, mutated_per_model=1,
                                      trace_steps=6, histories=9)
    assert got == want
    assert [r["kind"] for r in got].count("trace") == 6


def test_walk_from_a_terminal_state_is_refused():
    class Terminal:
        """A one-state model with no enabled action."""

        def __init__(self, inner):
            self._inner = inner

        def packed_init_states(self, device="cpu"):
            return self._inner.packed_init_states(device)

        def packed_expand(self, states):
            cand, valid = self._inner.packed_expand(states)
            return cand, valid & False

    with pytest.raises(ValueError, match="initial state is terminal"):
        random_walk_trace(Terminal(default_zoo()["2pc"]()), random.Random(0), 4)

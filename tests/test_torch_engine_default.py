"""The GPU checker's default engine: ``spawn_gpu_bfs()`` with no
``wave_kernel`` runs the fused wave, and the staged one under symmetry or
``expand_fps=True`` (which the fused wave refuses); ``config_notes`` names
the choice. An explicit ``"fused"`` with either still raises. The JAX
package's default stays ``"staged"``; the counts and paths are the same."""

import io
import re

import pytest

from stateright_tpu.models.single_copy_register import (
    SingleCopyModelCfg as JaxSingleCopyModelCfg,
)
from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys
from stateright_tpu_torch import WriteReporter
from stateright_tpu_torch.models.raft import RaftModelCfg
from stateright_tpu_torch.models.single_copy_register import SingleCopyModelCfg
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

SPAWN = dict(device="cpu", frontier_capacity=64, table_capacity=4096)
FUSED_NOTE = ("wave_kernel resolved to 'fused' (it rounds table_capacity up to a "
              "tile-aligned power of two)")


@pytest.mark.parametrize("mode", ["wave", "drain"])
def test_default_resolves_to_fused_and_matches_jax(mode):
    options = dict(max_drain_waves=1) if mode == "wave" else {}
    port = TwoPhaseSys(4).checker().spawn_gpu_bfs(**SPAWN, **options).join()
    ref = JaxTwoPhaseSys(4).checker().spawn_tpu_bfs(
        hashset_impl="xla", wave_dedup="sort", frontier_capacity=64,
        table_capacity=4096, **options).join()
    assert port._wave_kernel == "fused"
    assert port.config_notes == [FUSED_NOTE]
    assert port.unique_state_count() == ref.unique_state_count() == 1568
    assert port.state_count() == ref.state_count()
    assert port._discoveries_fp == ref._discoveries_fp
    buf = io.StringIO()
    port.report(WriteReporter(buf))
    assert f"Note: {FUSED_NOTE}\n" in re.sub(r"sec=\d+", "sec=*", buf.getvalue())


def test_default_rounds_the_table_capacity_as_fused_does():
    c = TwoPhaseSys(3).checker().spawn_gpu_bfs(device="cpu", table_capacity=3000).join()
    assert c._wave_kernel == "fused" and c.table_capacity() >= 4096
    assert c.config_notes[0] == FUSED_NOTE
    assert c.config_notes[1].startswith("table_capacity rounded 3000 -> 4096")
    assert c.unique_state_count() == 288


def test_default_resolves_to_staged_under_symmetry():
    c = TwoPhaseSys(3).checker().symmetry().spawn_gpu_bfs(**SPAWN).join()
    assert c._wave_kernel == "staged" and not c._use_fps
    assert c.config_notes == [
        "wave_kernel resolved to 'staged' (symmetry reduction runs on the staged wave)"]
    assert c.unique_state_count() == 80
    raft = RaftModelCfg(server_count=3, max_term=1).into_model()
    r = raft.checker().symmetry().spawn_gpu_bfs(**SPAWN).join()
    assert r._wave_kernel == "staged" and not r._use_fps
    assert r.unique_state_count() == 121


def test_default_resolves_to_staged_with_expand_fps():
    c = SingleCopyModelCfg(2, 1).into_model().checker().spawn_gpu_bfs(
        expand_fps=True, **SPAWN).join()
    assert c._wave_kernel == "staged" and c._use_fps
    assert c.config_notes == [
        "wave_kernel resolved to 'staged' (expand_fps=True runs on the staged wave)"]
    assert c.unique_state_count() == 93


@pytest.mark.parametrize("expand_fps", [None, False])
def test_default_expand_fps_resolves_for_the_fused_engine(expand_fps):
    """``expand_fps=None`` (or False) under the default resolves as it does
    for the fused engine: off. The JAX package's default (staged) turns it
    on for the same model; the counts agree."""
    c = SingleCopyModelCfg(2, 1).into_model().checker().spawn_gpu_bfs(
        expand_fps=expand_fps, **SPAWN).join()
    j = JaxSingleCopyModelCfg(2, 1).into_model().checker().spawn_tpu_bfs(
        frontier_capacity=64, table_capacity=4096).join()
    assert c._wave_kernel == "fused" and not c._use_fps
    assert j._use_fps
    assert c.unique_state_count() == j.unique_state_count() == 93


def test_explicit_fused_still_refuses_symmetry_and_expand_fps():
    with pytest.raises(ValueError, match="wave_kernel='fused'"):
        TwoPhaseSys(3).checker().symmetry().spawn_gpu_bfs(wave_kernel="fused", **SPAWN)
    with pytest.raises(ValueError, match="wave_kernel='fused'"):
        SingleCopyModelCfg(2, 1).into_model().checker().spawn_gpu_bfs(
            wave_kernel="fused", expand_fps=True, **SPAWN)
    with pytest.raises(ValueError, match="expand_fps"):
        TwoPhaseSys(3).checker().symmetry().spawn_gpu_bfs(expand_fps=True, **SPAWN)


def test_explicit_engines_add_no_engine_note():
    for wk in ("staged", "fused"):
        c = TwoPhaseSys(3).checker().spawn_gpu_bfs(wave_kernel=wk, **SPAWN).join()
        assert c._wave_kernel == wk and c.config_notes == []

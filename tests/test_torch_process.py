"""Processes and multi-sequence batches (``splatpu_torch.dist.process``,
``dist.multiseq``, ``cli.train_batch``) against the JAX package's, and run
as gloo ranks on the CPU through ``splatpu_torch.dist.launch``.

- ``local_camera_indices`` and ``job_assignments`` identical to JAX's over
  a grid of sizes; ``ProcessTopology`` refuses an index out of range and
  ``current()`` reads the process group (2 ranks), or (1, 0) without one;
- ``load_local_timestep_views`` of each of 2 processes identical to JAX's;
- ``train_sequences`` over 2 ranks and ``cli.train_batch`` over 2
  processes: every sequence's network, and its checkpoint file, bitwise
  those of an independent one-process run of it (the orchestration is a
  pure router); duplicate names refused; another process's jobs never
  resolved; ``--mesh-cameras`` with more than one process refused, and with
  one it trains every sequence on camera ranks;
- ``cli.train_batch``'s parser has every option of JAX's and ``--device``.
"""

import json

import numpy as np
import pytest
import torch

import splatpu.cli.train_batch as jbatch
import splatpu.data.dataset as jds
from splatpu.dist.multiseq import job_assignments as jjobs
from splatpu.dist.process import (
    ProcessTopology as JTopology,
    load_local_timestep_views as jload_local,
    local_camera_indices as jlocal,
)
import splatpu_torch.cli.train_batch as tbatch
import splatpu_torch.data.dataset as tds
from splatpu_torch.core import prng
from splatpu_torch.data.synthetic import lookat_matrices, make_random_cloud
from splatpu_torch.dist import ranks
from splatpu_torch.dist.launch import launch
from splatpu_torch.dist.multiseq import SequenceJob, job_assignments, local_jobs, train_sequences
from splatpu_torch.dist.process import (
    ProcessTopology,
    load_local_timestep_views,
    local_camera_indices,
)
from splatpu_torch.io.checkpoint import save_cloud
from splatpu_torch.train.stage2 import Stage2Config, train
from test_torch_cli import jax_parser, options
from test_torch_dataset import assert_views_equal
from _torch_scenes import np_cloud

torch.set_num_threads(1)

TIMEOUT_S = 180
W, H, C = 32, 24, 3


def test_assignments_match_jax():
    for n in (0, 1, 2, 3, 5, 8, 27):
        for count in (1, 2, 3, 4, 8):
            blocks = [local_camera_indices(n, ProcessTopology(count, i)) for i in range(count)]
            assert blocks == [jlocal(n, JTopology(count, i)) for i in range(count)]
            assert [c for b in blocks for c in b] == list(range(n))
            assert job_assignments(n, count) == jjobs(n, count)
    assert local_jobs(3, ProcessTopology(2, 1)) == [2]


def test_topology_validation_and_current(tmp_path):
    with pytest.raises(ValueError):
        ProcessTopology(count=2, index=2)
    assert ProcessTopology.current() == ProcessTopology(1, 0)
    assert launch(ProcessTopology.current, 2, (), tmp_path, device="cpu") == [ProcessTopology(2, 0),
                                                                 ProcessTopology(2, 1)]


def write_sequence(path, seed, frames=3):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(frames, C, 3, H, W)).astype(np.float32)
    segs = (rng.uniform(size=(frames, C, H, W)) > 0.5).astype(np.float32)
    cams = [lookat_matrices((3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)), width=W, height=H)
            for a in 2 * np.pi * np.arange(C) / C]
    w2c = np.tile(np.stack([c[0] for c in cams])[None], (frames, 1, 1, 1))
    K = np.tile(np.stack([c[1] for c in cams])[None], (frames, 1, 1, 1))
    tds.save_synthetic_sequence(path, images, segs, K, w2c,
                                rng.uniform(size=(50, 7)).astype(np.float32))
    save_cloud(path / "densified_initial_gaussian_cloud_parameters.npz",
               make_random_cloud(prng.key(seed), 200, device="cpu"))


def test_load_local_timestep_views_matches_jax(tmp_path):
    write_sequence(tmp_path, 0, frames=2)
    md_t, md_j = tds.load_metadata(tmp_path), jds.load_metadata(tmp_path)
    seen = []
    for i in range(2):
        got = load_local_timestep_views(md_t, 1, tmp_path, ProcessTopology(2, i))
        assert_views_equal(got, jload_local(md_j, 1, tmp_path, JTopology(2, i)))
        seen += [v.camera_index for v in got]
    assert seen == list(range(C))


def job_specs(n=3):
    rng = np.random.default_rng(5)
    specs = []
    for s in range(n):
        views = [[dict(camera_index=i, w2c=w2c, K=K, width=W, height=H,
                       image=rng.uniform(size=(3, H, W)).astype(np.float32),
                       segmentation=np.zeros((3, H, W), np.float32))
                  for i, (w2c, K) in enumerate(lookat_matrices(
                      (1.5 * np.sin(a), 0.3, -1.5 * np.cos(a)), width=W, height=H)
                      for a in (0.0, 2.1))]
                 for _t in range(2)]
        specs.append(dict(name=f"seq{s}", cloud=np_cloud(100 + s, 48, extent=0.6), views=views,
                          config=dict(total_iterations=2, warmup_iterations=1, hidden_dim=16,
                                      residual_blocks=1, views_per_step=1, timestep_count=2,
                                      renderer="plain", seed=s)))
    return specs


def test_train_sequences_over_two_ranks_match_independent_runs(tmp_path):
    specs = job_specs(3)
    got = launch(ranks.sequences_on_rank, 2, (specs, tmp_path / "out", "cpu"), tmp_path / "rdv",
                 device="cpu", timeout_s=TIMEOUT_S)
    assert [sorted(r["nets"]) for r in got] == [["seq0", "seq1"], ["seq2"]]
    assert all(r["jax_modules"] == [] for r in got)
    nets = {**got[0]["nets"], **got[1]["nets"]}
    for spec in specs:
        alone = ranks.train_on_rank(spec["cloud"], spec["views"], spec["config"], "cpu")["runs"][0]
        for k, v in alone["params"].items():
            np.testing.assert_array_equal(nets[spec["name"]][k], v, err_msg=k)
    for pid, names in ((0, ["seq0", "seq1"]), (1, ["seq2"])):
        for name in names:
            rec = json.loads((tmp_path / "out" / name / "result.json").read_text())
            assert (rec["sequence"], rec["process"], rec["completed"]) == (name, pid, True)
            assert "total" in rec["last_step"]
            assert (tmp_path / "out" / name / "train_metrics.jsonl").is_file()


def test_duplicate_names_refused_and_remote_jobs_never_resolved():
    spec = job_specs(1)[0]
    job = SequenceJob(name="seq0", initial_cloud=lambda: None, views_by_timestep=[],
                      config=Stage2Config(**spec["config"]))
    with pytest.raises(ValueError, match="duplicate"):
        train_sequences([job, job], topo=ProcessTopology())

    def boom():
        raise AssertionError("a job of another process was resolved")

    remote = SequenceJob(name="seq1", initial_cloud=boom, views_by_timestep=boom,
                         config=job.config)
    assert train_sequences([remote], topo=ProcessTopology(count=2, index=1)) == {}


def test_cli_parser_matches_jax(monkeypatch):
    want = options(jax_parser(jbatch.main, monkeypatch))
    got = options(tbatch.parser())
    assert list(got) == list(want) + ["device"]
    assert {k: v for k, v in got.items() if k != "device"} == want


def test_cli_train_batch_over_two_processes(tmp_path):
    for s in range(3):
        write_sequence(tmp_path / f"seq{s}", s)
    common = [str(tmp_path), "2", "1", "0.001", "16", "1", "--sequences", "seq0", "seq1", "seq2",
              "-t", "2", "--device", "cpu", "--renderer", "plain", "--checkpoint-every", "1"]
    with pytest.raises(SystemExit):
        tbatch.main([*common, "-o", str(tmp_path / "x"), "--num-processes", "2",
                     "--mesh-cameras", "2"])
    tbatch.main([*common, "-o", str(tmp_path / "out"), "--num-processes", "2"])
    tbatch.main([*common, "-o", str(tmp_path / "mesh"), "--mesh-cameras", "2"])
    for s in range(3):
        seq = tmp_path / f"seq{s}"
        md = tds.load_metadata(seq)
        from splatpu_torch.io.checkpoint import load_cloud

        ckpt = tmp_path / f"alone{s}.msgpack"
        train(load_cloud(seq / "densified_initial_gaussian_cloud_parameters.npz", device="cpu"),
              [tds.load_timestep_views(md, t, seq) for t in (1, 2)],
              Stage2Config(total_iterations=2, warmup_iterations=1, learning_rate=0.001,
                           hidden_dim=16, residual_blocks=1, timestep_count=2, renderer="plain",
                           checkpoint_every=1, checkpoint_path=str(ckpt)), device="cpu")
        rec = json.loads((tmp_path / "out" / f"seq{s}" / "result.json").read_text())
        assert rec["process"] == (0 if s < 2 else 1) and rec["process_count"] == 2
        assert (tmp_path / "out" / f"seq{s}" / "stage2_ckpt.msgpack").read_bytes() == \
            ckpt.read_bytes()
        rec = json.loads((tmp_path / "mesh" / f"seq{s}" / "result.json").read_text())
        assert rec["process_count"] == 1 and np.isfinite(rec["last_step"]["total"])

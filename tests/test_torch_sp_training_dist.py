"""Training under sequence parallelism over ``torch.distributed`` (gloo,
one process per rank, on the CPU): ``DistComm``'s gradients are
``ThreadComm``'s, and ``cli.finetune --sp_size 2`` runs under torchrun's
environment, full and QLoRA, rank 0 writing one checkpoint in the
one-process layout, and saves on every rank when one rank takes SIGTERM.

Two spawns, of four ranks and of two (``torch.multiprocessing``, one intra-op
thread each, so that every rank's arithmetic is a thread rank's). This
file imports neither JAX nor the JAX package."""

import json
import os
import signal
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from moviigen_tpu_torch.configs import WAN_CONFIGS
from moviigen_tpu_torch.models.wan_model import WanModel
from moviigen_tpu_torch.ops.rope import rope_3d_freqs
from moviigen_tpu_torch.parallel import sharding
from moviigen_tpu_torch.parallel.comm import (own_trained, run_ranks,
                                              thread_mesh)
from moviigen_tpu_torch.parallel.mesh import make_mesh
from moviigen_tpu_torch.training import TrainConfig, make_train_step
from moviigen_tpu_torch.training.train_step import mesh_global_norm
from test_torch_parallel_dist import _free_port, _spawn

CFG = WAN_CONFIGS["t2v-tiny"].model
GRID = (2, 4, 4)
# (name, sp_mode, seq_len): 32 tokens; the ring's padded to 48, so that
# its second key shard holds 8 keys and the padding
CASES = [("ulysses", "ulysses", None), ("ring", "ring", 48)]


def _write_dataset(tmp_path):
    """A synthetic latent cache in the reference layout (the one of
    ``test_torch_training.py``, which imports JAX): 12 items, two
    aspect-ratio bins, three lengths. Returns its json's path."""
    d = tmp_path / "ds"
    (d / "latent").mkdir(parents=True)
    (d / "prompt_embed").mkdir()
    annos = []
    rng = np.random.default_rng(0)
    for i in range(12):
        np.save(d / "latent" / f"v{i}.npy",
                rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
        np.save(d / "prompt_embed" / f"v{i}.npy",
                rng.standard_normal((5 + 6 * (i % 3), 32))
                .astype(np.float32))
        annos.append({"latent_path": f"v{i}.npy",
                      "prompt_embed_path": f"v{i}.npy",
                      "length": 3 + i % 3, "aspect_ratio_bin": i % 2})
    path = d / "videos2caption.json"
    path.write_text(json.dumps(annos))
    return str(path)


@pytest.fixture()
def tiny_dataset(tmp_path):
    return _write_dataset(tmp_path)


class GradCapture:
    def __init__(self, model, comm):
        self.names = [n for n, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.grads = None
        self.norm_fn = mesh_global_norm(comm, self.params)

    def step(self, grads, norm=None):
        self.grads = dict(zip(self.names, grads))
        return True


def _grads(comm, sp_mode, seq_len):
    """One SP step's metrics and this rank's gradients, fp32, remat."""
    gen = torch.Generator().manual_seed(0)
    model = WanModel(CFG, dtype=torch.float32).init_weights(gen)
    with torch.no_grad():
        model.head.weight.normal_(0.0, 0.1, generator=gen)  # live head
    m = own_trained(sharding.shard_params(
        model, sharding.dit_param_specs(model), comm,
        sharding.shard_axis(comm)))
    cap = GradCapture(m, comm)
    batch = {"latents": torch.randn(2, CFG.in_dim, 2, 8, 8, generator=gen),
             "context": torch.randn(2, CFG.text_len, CFG.text_dim,
                                    generator=gen)}
    metrics = make_train_step(
        m, TrainConfig(remat=True), rope_3d_freqs(GRID, CFG.head_dim), cap,
        seq_len=seq_len, compute_dtype=torch.float32, comm=comm,
        sp_mode=sp_mode)(batch, noise=torch.randn(
            batch["latents"].shape, generator=gen),
        u=torch.tensor([0.2, 0.8]))
    return metrics, cap.grads, set(sharding.sharded_tensors(m))


def _grad_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        comm = make_mesh(data=2, seq=world // 2)
        results = {name: _grads(comm, mode, seq_len)
                   for name, mode, seq_len in CASES}
        if rank == 0:  # the same mesh as threads of this process
            for name, mode, seq_len in CASES:
                results[f"{name}/threads"] = run_ranks(
                    lambda c: _grads(c, mode, seq_len),
                    thread_mesh(data=2, seq=world // 2))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_dist_comm_grads_equal_thread_comm(tmp_path):
    """Each gloo rank's loss and grad_norm are bit-equal to the thread
    rank's on the same (data 2, seq 2) mesh, in Ulysses and in the ring
    with padding, and its gradients (its shards, the replicated tensors
    whole) equal within 1e-6 of their scale: the data ranks' sums and the
    whole mesh's run over ``DistComm``'s groups of every set of axes, and
    gloo adds four ranks' terms in another order than ``ThreadComm``'s
    rank order. The replicated gradients are the same bits on every gloo
    rank (the all-reduce hands each the one sum)."""
    _spawn(_grad_worker, 4, 4, _free_port(), str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for name, _, _ in CASES:
        threads = ranks[0][f"{name}/threads"]
        for r in range(4):
            (got_m, got, shards), (want_m, want, _) = ranks[r][name], \
                threads[r]
            assert float(want_m["grad_norm"]) > 0
            for key in ("loss", "grad_norm"):
                assert torch.equal(got_m[key], want_m[key]), (name, key)
            assert set(got) == set(want)
            for n, g in want.items():
                scale = float(g.abs().max())
                assert torch.allclose(got[n], g, rtol=0,
                                      atol=1e-6 * scale), (name, r, n)
                if n not in shards:
                    assert torch.equal(got[n], ranks[0][name][1][n]), n


def _mesh_grad_worker(rank, world, port, out_dir, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, mode, seq_len, (data, ring, seq) in cases:
            comm = make_mesh(data=data, ring=ring, seq=seq)
            results[name] = _grads(comm, mode, seq_len)
            if rank == 0:  # the same mesh as threads of this process
                results[f"{name}/threads"] = run_ranks(
                    lambda c: _grads(c, mode, seq_len),
                    thread_mesh(data=data, ring=ring, seq=seq))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# (name, sp_mode, seq_len, mesh (data, ring, seq)): the ring over 4 ranks,
# its 48 padded tokens leaving the last key shard empty; hybrid USP
RING_USP_CASES = [("ring4_padded", "ring", 48, (1, 1, 4)),
                  ("usp2x2", "usp", None, (1, 2, 2)),
                  ("usp2x2_padded", "usp", 48, (1, 2, 2))]


@pytest.mark.parametrize("cases", [RING_USP_CASES], ids=["ring4_usp2x2"])
def test_dist_comm_ring_usp_grads_equal_thread_comm(tmp_path, cases):
    """The ring's and hybrid USP's training step over four gloo ranks
    (data 1) against the same meshes as thread ranks: loss and grad_norm
    the same bits, and every gradient (the shards and the replicated
    tensors) within 1e-6 of its scale: the whole-mesh sums (the
    replicated tensors', and the shards' reduce-scatters over the token
    axes) are gloo's four terms and ``ThreadComm``'s in their own orders,
    as in the (data 2, seq 2) test above."""
    _spawn(_mesh_grad_worker, 4, 4, _free_port(), str(tmp_path), cases)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for name, _, _, _ in cases:
        threads = ranks[0][f"{name}/threads"]
        for r in range(4):
            (got_m, got, shards), (want_m, want, _) = ranks[r][name], \
                threads[r]
            assert shards and float(want_m["grad_norm"]) > 0
            for key in ("loss", "grad_norm"):
                assert torch.equal(got_m[key], want_m[key]), (name, key)
            assert set(got) == set(want)
            for n, g in want.items():
                assert torch.allclose(got[n], g, rtol=0,
                                      atol=1e-6 * float(g.abs().max())), \
                    (name, r, n)


def _signalled_run(finetune, rank, argv):
    """``finetune.main(argv)`` with SIGTERM raised in rank 1 alone as its
    second step begins, while rank 0 goes on into the step's collectives;
    returns the code it exits with."""
    from moviigen_tpu_torch import training

    real = training.make_train_step

    def interrupted(*args, **kwargs):
        step, calls = real(*args, **kwargs), []

        def run(batch):
            calls.append(batch)
            if rank == 1 and len(calls) == 2:
                signal.raise_signal(signal.SIGTERM)
            return step(batch)

        return run

    training.make_train_step = interrupted
    try:
        finetune.main(argv)
    except SystemExit as e:
        return e.code
    finally:
        training.make_train_step = real
    return "no exit"


def _cli_worker(rank, world, port, data_json, out_dir):
    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # TensorFlow: seconds
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    argv = ["--task", "t2v-tiny", "--device", "cpu",
            "--data_json_path", data_json, "--num_latent_t", "2",
            "--max_train_steps", "2", "--checkpointing_steps", "100",
            "--learning_rate", "1e-4", "--gradient_checkpointing",
            "--sp_size", "2"]
    said = {}
    # one process group for the three runs (each would otherwise bring up
    # its own and take it down)
    distributed.maybe_initialize_distributed(device="cpu", strict=True)
    try:
        for name, extra in (("full", ["--export_safetensors"]),
                            ("qlora", ["--use_lora", "--quant", "int4",
                                       "--lora_rank", "4"])):
            record = finetune.main(argv + extra + [
                "--output_dir", os.path.join(out_dir, name)])
            said[name] = dict(loss=record["loss"], step=record["step"],
                              checkpoint=record["checkpoint"],
                              mesh=dict(record["comm"].shape))
        said["signal"] = _signalled_run(finetune, rank, argv + [
            "--max_train_steps", "4",
            "--output_dir", os.path.join(out_dir, "signal")])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(said, f)


@pytest.fixture(scope="module")
def finetune_sp2_runs(tmp_path_factory):
    """One spawn of two gloo ranks running ``cli.finetune --sp_size 2``
    three times (``_cli_worker``); (its directory, each rank's record)."""
    tmp_path = tmp_path_factory.mktemp("sp2")
    data_json = _write_dataset(tmp_path)
    _spawn(_cli_worker, 2, 2, _free_port(), data_json, str(tmp_path))
    return tmp_path, [json.loads((tmp_path / f"rank{r}.json").read_text())
                      for r in range(2)]


def test_finetune_cli_sp2_under_torchrun_env(finetune_sp2_runs,
                                             monkeypatch):
    """``cli.finetune --sp_size 2 --device cpu`` with torchrun's variables
    for two ranks (gloo, a (1, 2) mesh), 2 steps, full and with
    ``--use_lora --quant int4``: both ranks log the same losses, close to
    the one-process run's (bf16 compute, summed in other orders: within
    1e-2), and rank 0 alone writes the final checkpoint, which
    ``restore_checkpoint`` reads in one process (and ``load_wan_checkpoint``
    its reference-layout export)."""
    from moviigen_tpu_torch.cli import finetune
    from moviigen_tpu_torch.models.wan_convert import load_wan_checkpoint
    from moviigen_tpu_torch.training import make_optimizer
    from moviigen_tpu_torch.training.checkpoint import (read_meta,
                                                        restore_checkpoint)

    tmp_path, said = finetune_sp2_runs
    data_json = str(tmp_path / "ds" / "videos2caption.json")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for name in ("full", "qlora"):
        a, b = said[0][name], said[1][name]
        assert a["mesh"] == {"data": 1, "seq": 2} and a["step"] == 2
        assert a["loss"] == b["loss"] and a["checkpoint"] == b["checkpoint"]
        ckpt = tmp_path / name / "checkpoint-step_2"
        assert a["checkpoint"] == str(ckpt)
        argv = ["--task", "t2v-tiny", "--device", "cpu", "--data_json_path",
                data_json, "--num_latent_t", "2", "--max_train_steps",
                "2", "--learning_rate", "1e-4", "--gradient_checkpointing",
                "--output_dir", str(tmp_path / f"{name}_one")]
        if name == "qlora":
            argv += ["--use_lora", "--quant", "int4", "--lora_rank", "4"]
        one = finetune.main(argv)
        np.testing.assert_allclose(a["loss"], one["loss"], rtol=1e-2)
        assert read_meta(str(ckpt))["final"] is True
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == \
            ["checkpoint-step_2"]  # one checkpoint, by rank 0
        if name == "full":
            model = WanModel(CFG, dtype=torch.float32)
            opt = make_optimizer(list(model.parameters()), TrainConfig())
            assert restore_checkpoint(str(ckpt), model, opt) == 2
            assert opt.count == 2
            exported = load_wan_checkpoint(str(ckpt), CFG,
                                           dtype=torch.float32)
            for (n, p), q in zip(model.named_parameters(),
                                 exported.parameters()):
                assert torch.equal(p, q), n
        else:
            from moviigen_tpu_torch.training.lora import lora_state_dict

            template = lora_state_dict(one["adapters"])
            assert restore_checkpoint(str(ckpt), template) == 2


def test_finetune_cli_sp2_signal_saves_on_every_rank(finetune_sp2_runs):
    """SIGTERM to one rank of the same ``--sp_size 2`` run (rank 1, as its
    second of 4 steps begins): both ranks finish that step, save together
    (the save's gathers are collectives, met at the same point of the loop
    by every rank) and exit 0. The one checkpoint is step 2's, final, and
    bit-equal, parameters and optimizer state, to the 2-step run's; it
    resumes in one process."""
    from moviigen_tpu_torch.training.checkpoint import (OPT_FILE,
                                                        PARAMS_FILE,
                                                        read_meta,
                                                        restore_checkpoint)
    from moviigen_tpu_torch.training import make_optimizer
    from moviigen_tpu_torch.utils.safetensors import load_file

    tmp_path, said = finetune_sp2_runs
    assert [s["signal"] for s in said] == [0, 0]
    assert sorted(p.name for p in (tmp_path / "signal").iterdir()) == \
        ["checkpoint-step_2"]
    got = tmp_path / "signal" / "checkpoint-step_2"
    want = tmp_path / "full" / "checkpoint-step_2"
    assert read_meta(str(got))["final"] is True
    for file in (PARAMS_FILE, OPT_FILE):
        a, b = load_file(str(got / file)), load_file(str(want / file))
        assert set(a) == set(b) and a
        for name in a:
            assert torch.equal(a[name], b[name]), (file, name)
    model = WanModel(CFG, dtype=torch.float32)
    opt = make_optimizer(list(model.parameters()), TrainConfig())
    assert restore_checkpoint(str(got), model, opt) == 2
    assert opt.count == 2


def test_finetune_cli_sp_size_needs_ranks(tiny_dataset):
    """``--sp_size 2`` in a process alone (no torchrun) says how to launch
    the ranks."""
    from moviigen_tpu_torch.cli import finetune

    with pytest.raises(ValueError, match="torchrun"):
        finetune.main(["--task", "t2v-tiny", "--device", "cpu",
                       "--data_json_path", tiny_dataset, "--sp_size", "2"])

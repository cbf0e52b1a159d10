"""The (data × model) mesh of the attack engines, and the processes that run it. Counterpart of
adversarialvlm_tpu/parallel/mesh.py.

Axes:
  * ``data``: the question batch of each victim's forward and backward;
  * ``model``: tensor parallelism inside a victim (Megatron-style, parallel/sharding.py).

The JAX package is single-controller: one program over every device, whose collectives XLA
inserts. The port is multi-controller: :func:`launch` spawns one process a rank, and each rank
runs the whole attack on its shards, with the collectives written out in
parallel/collectives.py. Rank r sits at (data r // model, model r % model), the JAX mesh's
``devices.reshape(data, model)``, on card ``r % torch.cuda.device_count()`` or on the CPU.

The process group's backend follows the layout: NCCL when every rank has a card of its own, gloo
when ranks share a card (NCCL refuses two ranks on one device) or run on the CPU. The choice is
printed on a line of its own; there is no fallback from one to the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import tempfile

import torch


def mesh_shape(n_devices: int, data: int | None = None, model: int | None = None) -> tuple[int, int]:
    """(data, model) by the JAX package's rule (mesh.py:20-39): all tensor parallel when neither
    axis is given, the other axis derived from ``n_devices`` when one is; data × model must be
    ``n_devices``."""
    if data is None and model is None:
        data, model = 1, n_devices
    elif data is None:
        data = n_devices // model
    elif model is None:
        model = n_devices // data
    if data < 1 or model < 1 or data * model != n_devices:
        raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
    return data, model


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data × model) mesh: its coordinates, the process groups of its
    model row and its data column (None on an axis of size 1), and its device. ``ranks_on_device``
    is how many ranks share that device, which the decode budget divides its memory by.
    ``recompute_towers`` is set once, where the ranks are laid out (:func:`launch`): whether the
    replicated vision towers recompute their layers in the backward (:func:`recompute_replicated`)."""

    data: int
    model: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    model_group: object = None
    data_group: object = None
    backend: str | None = None
    ranks_on_device: int = 1
    recompute_towers: bool = False

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes a run's files."""
        return self.rank == 0


def make_mesh(n_devices: int | None = None, data: int | None = None, model: int | None = None,
              device=None, ranks_on_device: int = 1) -> Mesh | None:
    """This rank's :class:`Mesh` of ``n_devices`` ranks (default: the process group's world, or 1
    outside one), shaped by :func:`mesh_shape`. Inside an initialized process group every rank of
    the group must call it, in the same order, since it creates the model and data groups; the
    mesh covers the group's ranks 0..n_devices-1, and a rank past them gets None. Outside a
    process group it gives the layout alone, with no groups (one rank's mesh, or a shape to
    check)."""
    import torch.distributed as dist

    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if ready else 1
    n = n_devices or world
    d, m = mesh_shape(n, data, model)
    mesh = Mesh(d, m, device=torch.device(device or "cpu"), ranks_on_device=ranks_on_device)
    if not ready or n == 1:
        return mesh
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    me = dist.get_rank()
    mesh.rank, mesh.backend = (me if me < n else -1), dist.get_backend()
    # every rank of the process group creates every group, rows first, then columns
    for row in range(d):
        group = dist.new_group([row * m + j for j in range(m)]) if m > 1 else None
        if mesh.rank >= 0 and row == mesh.data_rank:
            mesh.model_group = group
    for col in range(m):
        group = dist.new_group([i * m + col for i in range(d)]) if d > 1 else None
        if mesh.rank >= 0 and col == mesh.model_rank:
            mesh.data_group = group
    return mesh if mesh.rank >= 0 else None


_ACTIVE: list[Mesh | None] = [None]


def active_mesh() -> Mesh | None:
    """The mesh the current code runs under (:func:`use_mesh`), or None."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Run the enclosed code under ``mesh``: the decoder's collectives, the step's batch split and
    the decode's cache read it (the JAX engine's ``jax.set_mesh``)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        yield mesh
    finally:
        _ACTIVE[0] = prev


def recompute_replicated() -> bool:
    """Whether the replicated vision towers recompute each layer in the backward instead of saving
    its activations: when the active mesh says so (``Mesh.recompute_towers``, which :func:`launch`
    sets where ranks share a card: each rank's share must hold its step, and a tower's saved
    attention probabilities are gigabytes an image) and a gradient is taken. The recomputed values
    are the saved ones."""
    mesh = active_mesh()
    return mesh is not None and mesh.recompute_towers and torch.is_grad_enabled()


def batch_rows(batch: int, mesh: Mesh | None = None) -> slice:
    """This rank's contiguous rows of a ``batch``-row batch on the data axis (the counterpart of
    ``data_sharded``); all rows (``slice(None)``) without a data axis, or when the axis does not
    divide the batch (:func:`dp_size`)."""
    mesh = mesh if mesh is not None else active_mesh()
    dp = dp_size(mesh, batch)
    if dp == 1:
        return slice(None)
    share = batch // dp
    return slice(mesh.data_rank * share, (mesh.data_rank + 1) * share)


def dp_size(mesh: Mesh | None, batch_size: int, warn: bool = False) -> int:
    """The data axis that splits a batch of ``batch_size``: the mesh's when it divides the batch,
    else 1, as JAX's ``_dp_spec`` (step.py:166-190) grants or refuses its spec. ``warn`` (once a
    step build, never per chunk) prints that an indivisible batch runs without data
    parallelism."""
    dp = mesh.data if mesh is not None else 1
    if dp <= 1:
        return 1
    if batch_size % dp:
        if warn:
            print(f"[attack] WARNING: batch_size {batch_size} is not divisible by the data mesh axis "
                  f"({dp}); data parallelism is DISABLED for this run — pick a batch that divides, "
                  "or drop --mesh_data", flush=True)
        return 1
    return dp


def choose_backend(device_type: str, n_ranks: int, n_cards: int) -> tuple[str, str]:
    """(backend, why) for ``n_ranks`` ranks on ``device_type`` with ``n_cards`` cards."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    if n_ranks <= n_cards:
        return "nccl", f"{n_ranks} ranks on {n_ranks} of {n_cards} cards"
    return "gloo", f"{n_ranks} ranks share {n_cards} card(s), which NCCL refuses"


def _rank_main(rank, call_path, data, model, device_type, backend, init_file, result_path, threads,
               n_cards):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    with open(call_path, "rb") as f:
        fn, args = pickle.load(f)
    n = data * model
    if device_type == "cuda":
        device = torch.device("cuda", rank % n_cards)
        per_card = len(range(rank % n_cards, n, n_cards))
        torch.cuda.set_device(device)
    else:
        device, per_card = torch.device("cpu"), n
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=n, **kw)
    try:
        mesh = make_mesh(n, data, model, device=device, ranks_on_device=per_card)
        # ranks that share a card recompute the replicated towers' layers: decided here, once
        mesh.recompute_towers = device.type == "cuda" and per_card > 1
        with use_mesh(mesh):
            out = fn(mesh, *args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, data: int, model: int, device="cuda", args=()):
    """Run ``fn(mesh, *args)`` on every rank of a ``data`` × ``model`` mesh, one spawned process a
    rank, and return rank 0's result. ``fn`` must be a module-level function (the ranks unpickle
    it). On the card the kernels are built here first, once, so the ranks find them built instead
    of each starting nvcc; each rank's torch takes 1 intra-op thread on the CPU, else the host's
    cores over the ranks, at most 4. ``fn`` and ``args`` reach the ranks through a file: spawn
    writes each process's arguments into its start-up pipe, and arguments past the pipe's buffer
    (an image as a numpy array) held the launch until that process had imported torch, so the
    ranks started one after another. A mesh of one rank runs ``fn`` in this process."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    n = data * model
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and n_cards == 0:
        raise RuntimeError("no CUDA device: the port runs on the card; pass device='cpu' to run on the CPU")
    if n == 1:
        dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
        with use_mesh(None):
            return fn(Mesh(1, 1, device=dev), *args)
    if device_type == "cuda":
        from adversarialvlm_tpu_torch.ops.kernels.build import build_all

        build_all()
    backend, why = choose_backend(device_type, n, n_cards)
    threads = 1 if device_type == "cpu" else max(1, min(4, (os.cpu_count() or 1) // n))
    print(f"mesh: data {data} x model {model} = {n} ranks, backend {backend} ({why})", flush=True)
    tmp = tempfile.mkdtemp(prefix="advlm_mesh_")
    try:
        result_path, call_path = os.path.join(tmp, "rank0.pkl"), os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        mp.spawn(_rank_main, args=(call_path, data, model, device_type, backend, os.path.join(tmp, "rendezvous"),
                                   result_path, threads, n_cards), nprocs=n, join=True)
        with open(result_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

"""Several hosts: a 2-D ("host", "chip") mesh of processes.

Counterpart of ``tpupt/parallel/multihost.py``. Every process calls
``initialize_distributed`` once and builds the same pod mesh; rank = host *
chips_per_host + chip. The forward pass needs no communication (each process
traces a disjoint sample shard of a replicated scene); the film is summed
hierarchically: first over the chips of a host (NVLink), then once across hosts,
over the group of each chip position.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .sharding import all_reduce_film, local_device


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           backend=None, device=None) -> None:
    """Join the process group: a no-op for one process or when already joined.

    The arguments default to torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR,
    MASTER_PORT: ``env://``). coordinator_address "host:port" rendezvouses over
    ``tcp://`` (an address with a scheme, such as ``file://``, is taken as it is). The
    backend is NCCL when the process's device (default cuda:{LOCAL_RANK}) is a card,
    gloo on the CPU; the caller may name one.
    """
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    dev = torch.device(device) if device is not None else local_device()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        rank = int(os.environ.get("RANK", "0")) if process_id is None else process_id
        dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=rank)


@dataclasses.dataclass(frozen=True)
class PodMesh:
    """A 2-D mesh ("host", "chip") of processes. host_group holds this host's chips,
    chip_group this chip position on every host; both None for a pod of one."""

    host_group: object
    chip_group: object
    n_hosts: int
    chips_per_host: int
    host: int
    chip: int
    device: torch.device
    axis_names: tuple = ("host", "chip")

    @property
    def size(self) -> int:
        return self.n_hosts * self.chips_per_host

    @property
    def index(self) -> int:
        """The flattened shard id over the pod."""
        return self.host * self.chips_per_host + self.chip

    def all_reduce(self, tensor: torch.Tensor) -> None:
        """Sum `tensor` in place over the pod: within the host, then across hosts."""
        if self.host_group is not None:
            dist.all_reduce(tensor, group=self.host_group)
            dist.all_reduce(tensor, group=self.chip_group)


def make_pod_mesh(n_hosts: int | None = None, chips_per_host: int | None = None,
                  device=None) -> PodMesh | None:
    """The pod mesh over the first n_hosts * chips_per_host ranks. Defaults: torchrun's
    LOCAL_WORLD_SIZE chips a host, and as many hosts as the world holds. Every rank must
    call this (it builds one group a host and one a chip position); ranks outside the
    pod get None."""
    dev = torch.device(device) if device is not None else local_device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if chips_per_host is None:
        chips_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if n_hosts is None else world // n_hosts
    if n_hosts is None:
        n_hosts = world // chips_per_host
    need = n_hosts * chips_per_host
    if world < need:
        raise RuntimeError(
            f"pod mesh ({n_hosts} hosts x {chips_per_host} chips) needs {need} devices, "
            f"only {world} process(es) in the process group"
        )
    if not dist.is_initialized():
        return PodMesh(None, None, 1, 1, 0, 0, dev)
    rank = dist.get_rank()
    host_groups = [dist.new_group([h * chips_per_host + c for c in range(chips_per_host)])
                   for h in range(n_hosts)]
    chip_groups = [dist.new_group([h * chips_per_host + c for h in range(n_hosts)])
                   for c in range(chips_per_host)]
    if rank >= need:
        return None
    host, chip = divmod(rank, chips_per_host)
    return PodMesh(host_groups[host], chip_groups[chip], n_hosts, chips_per_host, host, chip, dev)


def pod_sample_step(mesh: PodMesh, max_depth: int, has_lights: bool, width: int):
    """Build the pod step: build(k_per_chip) -> step(sd, cam, pixel_ids, sample0,
    spp_limit, seed) -> (film sum [pb,3], rays). Each chip streams its k-sample slice of
    the pixel block through the production wavefront (renderer._chunk_film); the film
    is summed hierarchically."""
    from ..render.renderer import _chunk_film

    def build(k_per_chip: int):
        def step(sd, cam, pixel_ids, sample0, spp_limit, seed):
            film, rays, _ = _chunk_film(
                sd, cam, pixel_ids, pixel_ids.shape[0], sample0 + mesh.index * k_per_chip,
                spp_limit, seed, k=k_per_chip, r=1, max_depth=max_depth,
                has_lights=has_lights, width=width,
            )
            return all_reduce_film(mesh, film, rays)

        return step

    return build


def render_block_pod(compiled, camera, pixel_ids, rows, cols, spp: int, seed: int = 0,
                     mesh: PodMesh | None = None):
    """Render a pixel block with the sample axis sharded over the whole pod ->
    (film sum [pb,3], rays int), the same on every rank."""
    mesh = mesh or make_pod_mesh()
    assert spp % mesh.size == 0, f"spp {spp} must divide over {mesh.size} pod chips"
    k = spp // mesh.size
    sd = compiled.data
    step = pod_sample_step(mesh, camera.max_depth, compiled.has_lights, camera.image_width)(k)
    pix = torch.as_tensor(pixel_ids, dtype=torch.int32, device=sd.device)
    return step(sd, camera.init(sd.device), pix, 0, spp, seed)

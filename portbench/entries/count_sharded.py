"""``kmix-torch``'s library call for a multi-GPU host:
``api.count_kmers_sharded_result`` over a mesh of the configuration's
``devices`` cards, one table slot a card, in one process. The
configuration asks for no output.

Under ``KRUST_PLATFORM=cpu`` (the CPU tests) the mesh is that many slots
of the CPU, as the port's own mesh tests build it."""

from __future__ import annotations


def run(path: str, config: dict):
    from krust_tpu_torch import api
    from krust_tpu_torch.io.format import SequenceFormat
    from krust_tpu_torch.parallel.mesh import make_mesh
    from krust_tpu_torch.utils.config import forced_platform

    n = config["devices"]
    mesh = make_mesh(devices=["cpu"] * n) if forced_platform() == "cpu" else \
        make_mesh(n_devices=n)
    return api.count_kmers_sharded_result(path, config["k"], SequenceFormat.AUTO,
                                          config["min_quality"], mesh=mesh)

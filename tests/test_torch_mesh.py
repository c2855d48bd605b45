"""The port's device meshes (``repro_torch.launch.mesh``) against the JAX
package's ``repro.launch.mesh``: axis names and shapes, explicit device
order, the count errors, and imports that leave CUDA uninitialised."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.launch import mesh as jmesh
from repro_torch.launch.mesh import Mesh, make_data_mesh, make_local_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_local_mesh_matches_reference():
    m, jm = make_local_mesh(device="cpu"), jmesh.make_local_mesh()
    assert m.axis_names == tuple(jm.axis_names) == ("data", "model")
    assert m.shape == dict(jm.shape) == {"data": 1, "model": 1}
    assert m.devices == (torch.device("cpu"),) and m.size == 1


def test_data_mesh_matches_reference():
    jm = jmesh.make_data_mesh(1)
    m = make_data_mesh(1, ["cpu"])
    assert m.axis_names == tuple(jm.axis_names) == ("data",)
    assert m.shape == dict(jm.shape) == {"data": 1}
    m3 = make_data_mesh(devices=["cpu"] * 3)
    assert m3.shape == {"data": 3} and m3.size == 3
    assert make_data_mesh(2, ["cpu"] * 3).size == 2


def test_data_mesh_keeps_the_given_order():
    """The fabric assigns lane blocks in mesh order; a permuted device
    list must stay as given (built without touching a card)."""
    devs = [torch.device("cuda", 1), torch.device("cuda", 0)]
    m = make_data_mesh(devices=devs)
    assert m.devices == tuple(devs)
    assert make_data_mesh(1, devices=devs).devices == (devs[0],)


def test_data_mesh_rejects_bad_counts():
    with pytest.raises(ValueError, match="n_devices=0"):
        make_data_mesh(0, ["cpu"])
    with pytest.raises(ValueError, match="n_devices=4 but 3"):
        make_data_mesh(4, ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 CUDA device"):
            make_data_mesh()
        with pytest.raises(ValueError, match="CUDA device"):
            make_data_mesh(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_local_mesh()


def test_mesh_rejects_one_card_twice_and_mixed_types():
    for devs in (["cuda:0", "cuda:0"], ["cuda", "cuda:0"]):
        with pytest.raises(ValueError, match="twice"):
            make_data_mesh(devices=devs)
    with pytest.raises(ValueError, match="one type"):
        make_data_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="needs 2 devices"):
        Mesh(("cpu",), ("data", "model"), (2, 1))
    with pytest.raises(dataclasses.FrozenInstanceError):
        make_data_mesh(1, ["cpu"]).axis_names = ("model",)


def test_import_leaves_cuda_uninitialised():
    code = ("import torch, repro_torch.launch.mesh, "
            "repro_torch.launch.fabric, repro_torch.core.sweep\n"
            "from repro_torch.launch.mesh import make_data_mesh\n"
            "make_data_mesh(devices=['cuda:0', 'cuda:1'])\n"
            "print('INIT', torch.cuda.is_initialized())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "INIT False" in r.stdout

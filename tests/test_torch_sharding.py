"""The port's sharding helpers (ocrs_tpu_torch.parallel.sharding) against
the JAX package's (ocrs_tpu.parallel.sharding) on the 8 virtual JAX CPU
devices of tests/conftest.py.

``make_data_mesh`` takes CUDA devices by default (there are none here, so it
raises), CPU entries when asked, and repeated devices. ``shard_batch_dim``'s
slices equal the per-device data of JAX's on meshes of 2 and 4; uneven
batches raise ``ValueError`` as JAX's ``device_put`` does, and so does a
97-column head under a model split of 2 (JAX's ``init_recognition_state``).
The leaves the port splits over ``"model"`` are the ones JAX's
``_shard_leaf_specs_recognition`` shards.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ocrs_tpu.parallel import sharding as jsharding
from ocrs_tpu.train import train as jtrain
from ocrs_tpu_torch.models.recognition_net import RecognitionModel
from ocrs_tpu_torch.models.weights import params_to_jax
from ocrs_tpu_torch.parallel import sharding
from ocrs_tpu_torch.train import train as ttrain


def test_make_data_mesh_takes_cuda_by_default_and_raises_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_data_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_data_mesh(2)


def test_make_data_mesh_cpu_entries_and_repeated_devices():
    mesh = sharding.make_data_mesh(4, device_type="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.shape == {"data": 4} and mesh.size == 4
    assert sharding.make_data_mesh(device_type="cpu").size == 1
    twice = sharding.make_data_mesh(devices=["cpu", "cpu"])
    assert twice.devices == (torch.device("cpu"), torch.device("cpu"))
    assert sharding.make_data_mesh(1, devices=["cpu", "meta"]).devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        sharding.make_data_mesh(devices=[])
    with pytest.raises(ValueError, match="device_type"):
        sharding.make_data_mesh(device_type="tpu")


@pytest.mark.parametrize("n, shape", [(2, (8, 3)), (4, (8, 2, 5)), (4, (4,))])
def test_shard_batch_dim_slices_equal_jax_per_device_data(n, shape):
    x = np.random.default_rng(n).standard_normal(shape).astype(np.float32)
    jmesh = jsharding.make_data_mesh(n)
    sharded = jsharding.shard_batch_dim(jmesh, jax.numpy.asarray(x))
    by_device = {shard.device: np.asarray(shard.data) for shard in sharded.addressable_shards}
    want = [by_device[d] for d in jmesh.devices.flat]
    got = sharding.shard_batch_dim(sharding.make_data_mesh(n, device_type="cpu"), x)
    assert len(got) == n
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.numpy(), w)
    # Tensors shard the same way, and the host split keeps numpy views.
    t = sharding.shard_batch_dim(sharding.make_data_mesh(n, device_type="cpu"), torch.from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(t, got))
    views = sharding.split_batch_dim(sharding.make_data_mesh(n, device_type="cpu"), x)
    assert all(v.base is x for v in views)


@pytest.mark.parametrize("n, rows", [(2, 5), (4, 6), (4, 2)])
def test_uneven_batch_raises_as_jax_does(n, rows):
    x = np.zeros((rows, 3), np.float32)
    with pytest.raises(ValueError):
        jsharding.shard_batch_dim(jsharding.make_data_mesh(n), jax.numpy.asarray(x))
    with pytest.raises(ValueError, match="split evenly"):
        sharding.shard_batch_dim(sharding.make_data_mesh(n, device_type="cpu"), x)
    with pytest.raises(ValueError, match="split evenly"):
        sharding.split_batch_dim(sharding.make_data_mesh(n, device_type="cpu"), x)


@pytest.mark.parametrize("arch", ["crnn", "convctc"])
def test_a_97_column_head_does_not_split_over_model_2_as_in_jax(arch):
    mesh = jtrain.make_mesh(2, model_parallel=2)
    with mesh, pytest.raises(ValueError):
        jtrain.init_recognition_state(mesh, optax.adam(1e-3), n_classes=97, hidden=8, arch=arch)
    # The port's column split takes its bounds from the same rule.
    with pytest.raises(ValueError, match="split evenly"):
        sharding.shard_bounds(97, 2)
    assert sharding.shard_bounds(24, 2) == [(0, 12), (12, 24)]


@pytest.mark.parametrize("arch", ["crnn", "convctc"])
def test_split_leaves_are_jax_shard_leaf_specs(arch):
    model = RecognitionModel.create(seed=0, n_classes=12, hidden=16, arch=arch)
    tree = params_to_jax(model.net.state_dict())
    specs = jtrain._shard_leaf_specs_recognition(tree)
    jax_split = {
        jax.tree_util.keystr(path) for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, P))[0] if spec == P(None, "model")
    }
    port_split = {
        "".join(f"[{k}]" if k.isdigit() else f"['{k}']" for k in name.split("."))
        for name, p in model.net.named_parameters() if ttrain.is_split_leaf(name, p.ndim)
    }
    assert port_split == jax_split and port_split


def test_replicate_copies_once_per_distinct_device():
    mesh = sharding.make_data_mesh(devices=["cpu", "meta", "cpu", "meta"])
    model = torch.nn.Linear(3, 2)
    tree = {"model": model, "x": np.ones(3, np.float32), "t": torch.zeros(2), "n": 5}
    out = sharding.replicate(mesh, tree)
    assert out[0]["model"] is model is out[2]["model"]
    assert out[1]["model"] is out[3]["model"] and out[1]["model"] is not model
    assert out[1]["model"].weight.device == torch.device("meta") and model.weight.device == torch.device("cpu")
    assert out[0]["t"] is tree["t"] and out[1]["x"].device == torch.device("meta")
    assert all(o["n"] == 5 for o in out)

"""Shared helpers for the parity tests of the PyTorch port (`icpx_torch`)
against the JAX package (`icpx`). Not collected (no `test_` prefix).

Inputs are made once with numpy, then handed to both packages as the same
bits: JAX objects go to numpy and through `icpx_torch.interop`.
"""

import dataclasses

import numpy as np
import torch

from icpx.cloud import PointCloud as JCloud
from icpx_torch import interop

# The suite runs under pytest-xdist with several workers: keep each
# worker's intra-op pool small so they do not oversubscribe the host.
torch.set_num_threads(2)


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clouds(xyz, normals=None, capacity=None):
    """(JAX PointCloud, port PointCloud) from one (n, 3) numpy array,
    padded once by the JAX package and carried across as numpy."""
    jc = JCloud.create(xyz, normals=normals, capacity=capacity)
    tc = torch_cloud(jc)
    return jc, tc


def torch_cloud(jc, device="cpu"):
    def host(x):
        return None if x is None else np.asarray(x)

    return interop.cloud_from_numpy(
        np.asarray(jc.xyz), np.asarray(jc.mask), host(jc.normals), host(jc.covs),
        host(jc.feats), jc.feat_names, device=device
    )


def torch_se3(js, device="cpu"):
    return interop.se3_from_numpy(np.asarray(js.R), np.asarray(js.t), device=device)


def torch_config(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def torch_pyramid_config(jcfg):
    return interop.pyramid_config_from_dict(dataclasses.asdict(jcfg))


def rotation(rng, max_angle=3.0) -> np.ndarray:
    """A float32 rotation matrix of a random axis and an angle up to
    `max_angle`, from numpy (Rodrigues)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).astype(np.float32)


def torch_odometry_config(jcfg):
    """The port's OdometryConfig from the JAX package's, field for field."""
    from icpx_torch.odometry.frontend import OdometryConfig

    d = dataclasses.asdict(jcfg)
    d["icp"] = interop.config_from_dict(d["icp"])
    return OdometryConfig(**d)


# ---- the two command lines -----------------------------------------------------------


def run_both(capsys, make_argv, tmp_path):
    """Run make_argv(out_dir) through `icpx.cli.main` and
    `icpx_torch.cli.main` (on the CPU), each with its own output
    directory: (JAX's stdout, the port's stdout, JAX's dir, the port's)."""
    import icpx.cli as j_cli
    import icpx_torch.cli as t_cli

    outs = []
    for name, main, extra in (("jax", j_cli.main, []), ("torch", t_cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        capsys.readouterr()
        assert main(extra + make_argv(d)) == 0
        outs.append(capsys.readouterr().out)
    return outs[0], outs[1], tmp_path / "jax", tmp_path / "torch"


def cli_rows(out, title, rows):
    """The matrix rows a CLI printed under the line `title`."""
    lines = out.splitlines()
    i = lines.index(title)
    return np.array([[float(v) for v in line.split()] for line in lines[i + 1:i + 1 + rows]])


def cli_transform(out):
    return cli_rows(out, "transform:", 4)


def cli_ate(out):
    """The ATE the CLI printed ("ATE 0.0767 m   RPE ...")."""
    return float(next(line for line in out.splitlines() if line.startswith("ATE ")).split()[1])


def cli_counts_line(out):
    return next(line for line in out.splitlines() if " frames, " in line)


def cli_refuses(argv, match):
    """Both CLIs exit on `argv` with a message matching `match`."""
    import pytest

    import icpx.cli as j_cli
    import icpx_torch.cli as t_cli

    for main, extra in ((j_cli.main, []), (t_cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=match):
            main(extra + argv)

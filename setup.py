"""Packaging. reference: setup.py:19-34 (same console-script surface)."""
import os
import re

from setuptools import find_packages, setup


def _version():
    init = open(os.path.join(os.path.dirname(__file__), "mbexwn_vocoder_tpu", "__init__.py")).read()
    m = re.search(r"mbexwn_tpu_version\s*=\s*\((\d+),\s*(\d+),\s*(\d+)\)", init)
    return ".".join(m.groups())


setup(
    name="mbexwn_vocoder_tpu",
    version=_version(),
    description="TPU-native (JAX/XLA/Pallas) Multi-Band Excited WaveNet neural vocoder",
    packages=find_packages(exclude=("tests",)),
    package_data={"mbexwn_vocoder_tpu": ["models_registry/*/config.yaml", "models_registry/common/*.yaml"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "pyyaml"],
    entry_points={
        "console_scripts": [
            "mbexwn_generate_mel=mbexwn_vocoder_tpu.cli.generate_mel:cli",
            "mbexwn_resynth_mel=mbexwn_vocoder_tpu.cli.resynth_mel:cli",
            "mbexwn_view_mel=mbexwn_vocoder_tpu.cli.view_mel:cli",
            "mbexwn_train=mbexwn_vocoder_tpu.cli.train:cli",
            "mbexwn_convert_checkpoint=mbexwn_vocoder_tpu.cli.convert_checkpoint:cli",
            "mbexwn_export_model=mbexwn_vocoder_tpu.cli.export_model:cli",
            # the PyTorch / H100 port (mbexwn_vocoder_torch)
            "mbexwn_torch_generate_mel=mbexwn_vocoder_torch.cli.generate_mel:cli",
            "mbexwn_torch_resynth_mel=mbexwn_vocoder_torch.cli.resynth_mel:cli",
            "mbexwn_torch_view_mel=mbexwn_vocoder_torch.cli.view_mel:cli",
            "mbexwn_torch_train=mbexwn_vocoder_torch.cli.train:cli",
        ]
    },
)

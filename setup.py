"""Packaging for edrgp_tpu (reference packaging surface: setup.py at the
reference root, v0.2.6 MIT — this is the TPU-native successor)."""

import os
import subprocess

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    """``python setup.py build_native`` — compile the C++ data loader."""

    description = "build the native minibatch data loader"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        subprocess.run(["make", "-C", os.path.join(here, "native")],
                       check=True)


setup(
    name="edrgp-tpu",
    version="0.1.0",
    description=("TPU-native effective dimensionality reduction with "
                 "Gaussian processes (JAX/XLA/Pallas)"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    packages=find_packages(include=["edrgp_tpu", "edrgp_tpu.*",
                                    "edrgp_tpu_torch", "edrgp_tpu_torch.*"]),
    package_data={"edrgp_tpu_torch": ["ops/cuda/*.cu", "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
        "scipy",
        "scikit-learn>=1.0",
        "optax>=0.2.0",
    ],
    cmdclass={"build_native": BuildNative},
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Science/Research",
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
    ],
)

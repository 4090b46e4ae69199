from setuptools import find_packages, setup

setup(
    name="tlxcv_tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas) computer-vision framework — "
                 "a from-scratch rebuild of the capabilities of "
                 "tensorlayer/TLXCV"),
    packages=find_packages(include=["tlxcv_tpu", "tlxcv_tpu.*",
                                    "tlxcv_tpu_torch", "tlxcv_tpu_torch.*"]),
    package_data={"tlxcv_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy"],
)

from setuptools import find_packages, setup

setup(
    name="pysgmcmc_tpu",
    version="0.1.0",
    description="TPU-native Stochastic Gradient MCMC framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={
        "pysgmcmc_tpu": ["native/*.cpp"],
        "pysgmcmc_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"torch": ["torch"]},
)

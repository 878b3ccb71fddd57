from setuptools import find_packages, setup

setup(
    name="fiber-tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed computing framework: a multiprocessing-"
        "compatible API (Process/Pool/Queue/Pipe/Manager/Ring) whose "
        "backend is a Cloud TPU pod slice and whose device plane is "
        "JAX/XLA over ICI"
    ),
    packages=find_packages(include=["fiber_tpu", "fiber_tpu.*",
                                    "fiber_tpu_torch", "fiber_tpu_torch.*"]),
    package_data={"fiber_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "cloudpickle",
        "psutil",
    ],
    extras_require={
        "device": ["jax"],
    },
    entry_points={
        "console_scripts": [
            "fiber-tpu=fiber_tpu.cli:main",
            "fiber-tpu-torch=fiber_tpu_torch.cli:main",
        ],
    },
)

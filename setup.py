"""Install: pip install -e .  (the environment already has all dependencies)."""
from setuptools import find_packages, setup

setup(
    name="dpgo_tpu",
    version="0.1.0",
    description=(
        "Distributed certifiably-correct pose-graph optimization in JAX "
        "(a re-design of mit-acl/dpgo)"
    ),
    packages=find_packages(include=["dpgo_tpu", "dpgo_tpu.*"]),
    python_requires=">=3.10",
)

# Reproducible environment image — the role of the reference's
# Dockerfile (reference docker/Dockerfile:50-79, which builds the exact
# PETSc configuration its benchmarks were measured against).  tpufem's
# dependency surface is far smaller: JAX + numpy/scipy with every
# version pinned in pyproject.toml, plus g++ for the optional native
# setup accelerators (tpufem/native/fastsetup.cpp — compiled on first
# import, transparent numpy fallback without a toolchain).
#
# CPU image (tests + virtual 8-device SPMD suite):
#   docker build -t tpufem .
#   docker run tpufem python -m pytest tests/ -q
# On an NVIDIA GPU host, install JAX with its CUDA plugin instead
# (pip install "jax[cuda12]==0.9.0", or base on an image that carries
# the CUDA toolkit) and drop the JAX_PLATFORMS=cpu line below;
# everything else is identical.
FROM python:3.12-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/tpufem
COPY pyproject.toml README.md ./
COPY tpufem ./tpufem
COPY tests ./tests
COPY bench.py chip_smoke.py ./

# pinned versions resolve from pyproject.toml; [dev] adds pytest + h5py
RUN pip install --no-cache-dir -e ".[dev]"

# pre-build the native module so first container use pays no compile
RUN python -c "from tpufem import native; assert native.have_native()"

# the test suite's virtual 8-device CPU mesh (tests/conftest.py sets
# this too; exported here for ad-hoc runs)
ENV JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8

CMD ["python", "-m", "pytest", "tests/", "-q"]

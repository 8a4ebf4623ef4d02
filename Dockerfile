# Packaging parity with the reference's 2-stage Dockerfile: the framework
# plus the native host kernels in a slim Python image (CPU JAX; a GPU
# deployment installs JAX's CUDA plugin instead).
FROM python:3.12-slim AS build
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*
WORKDIR /opt/lattisense-tpu
COPY csrc/ csrc/
RUN make -C csrc

# Go offload adapter (reference image ships Go 1.24; plug-in/lattigo
# counterpart). Builds the cgo client against liblattisense_plugin.so so
# the image can run the Go round-trip (tests/test_plugin_go.py).
FROM golang:1.24-bookworm AS gobuild
WORKDIR /opt/lattisense-tpu
COPY csrc/ csrc/
COPY plugin/go/ plugin/go/
RUN make -C csrc plugin && \
    cd plugin/go && \
    go vet ./lattisense ./cmd/runtask && \
    go build -o /opt/lattisense-tpu/bin/runtask ./cmd/runtask

FROM python:3.12-slim
RUN pip install --no-cache-dir "jax[cpu]" numpy pytest
WORKDIR /opt/lattisense-tpu
COPY lattisense_tpu/ lattisense_tpu/
COPY examples/ examples/
COPY tests/ tests/
COPY pyproject.toml README.md ./
COPY --from=build /opt/lattisense-tpu/csrc/ csrc/
ENV PYTHONPATH=/opt/lattisense-tpu
CMD ["python", "-m", "pytest", "tests/", "-q"]

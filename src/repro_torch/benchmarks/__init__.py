"""The paper's runners on the port (counterparts of the reference's
``benchmarks/`` scripts, one module per artifact).

Each ``run(..., device=None)`` takes the reference runner's arguments,
computes its payload (claim booleans included) on ``device`` — the CUDA
card by default — and writes ``results/torch/<name>.json``, beside and
never over the reference's ``results/<name>.json``:

    python -m repro_torch.benchmarks.table5            # on the card
"""

"""The paper suites on the port: one module per suite, the runner in
:mod:`repro_torch.bench.run`."""

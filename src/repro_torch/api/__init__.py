"""The port's experiment API (part of ``repro.api``): so far the report
helpers the paper suites share (:mod:`repro_torch.api.report`)."""

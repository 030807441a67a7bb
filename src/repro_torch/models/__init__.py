"""The LM substrate of the port: layers and the `dense` / `ssm` / `hybrid`
families.

Import submodules directly (repro_torch.models.lm etc.); this package init
stays empty to avoid import cycles with repro_torch.configs.
"""

"""Command-line entry points of the port (`python -m videocof_torch.cli.<name>`)."""

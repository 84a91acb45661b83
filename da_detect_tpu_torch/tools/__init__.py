"""Command-line tools of the port: train and evaluate from datasets on
disk (``python -m da_detect_tpu_torch.tools.<tool> --config-file ...``)."""

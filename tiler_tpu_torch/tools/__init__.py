"""On-card experiment entry points: the counterparts of tools/*.py that
run the 1-NN kernel variants (python -m tiler_tpu_torch.tools.<name>)."""

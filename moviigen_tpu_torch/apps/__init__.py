"""Applications of the PyTorch port (the gradio web UI)."""

from vulkanraytracing_torch.hybrid.renderer import render_hybrid  # noqa: F401

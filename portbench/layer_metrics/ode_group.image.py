"""Images a grouped ODE dispatch of the multimodal serving engine
integrated over the window: the engine's own counters (`stats`:
modality_tokens over an image's rows, over ode_dispatches) at the
window's open and close (source: program_counter)."""


def read(ctx):
    dispatches = ctx.get("ode_dispatches")
    return ctx["ode_images"] / dispatches if dispatches else None

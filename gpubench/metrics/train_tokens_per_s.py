"""Every token fed to the step over the whole window: from the sync that
opened it to the last sync in it."""


def read(ctx):
    return sum(units for _, _, units, _ in ctx.window.items) / ctx.window.seconds

"""True residues of the complexes packed (PDB text in hand) over the
window: from its start until the last request started in it is done."""


def read(ctx):
    return ctx.window["residues"] / ctx.window["seconds"]

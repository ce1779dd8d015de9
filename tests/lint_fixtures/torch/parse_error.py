"""Parse-error fixture: deliberately unparseable."""
def broken(:
    return

"""Seconds per edit: the window's seconds over the edits completed in it
(host clock; the device synchronised at the window's ends)."""


def read(w):
    return w.seconds / w.edits if w.edits else None

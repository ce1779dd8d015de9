"""Strict-mode fixture: a suppression naming a rule id that does not
exist — clean under the default exit code, exit 2 under --strict."""


def fine():  # repro-torch-lint: disable=RPT999
    return 0

"""Share of the window spent inside ``Engine.submit`` of documents, where
``TextAnalysisWorkload.make_request`` runs the text front end (host
clock, the harness's span around each call)."""


def read(run):
    if run.kind != "serve" or not run.text:
        return None
    return 100.0 * run.window.submit_s / run.window.seconds

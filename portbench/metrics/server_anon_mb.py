"""server_anon_mb: the device server's anonymous resident memory
(``RssAnon``) as it replied to each run's ``finish``, in MB, the highest
over the window's runs (run report ``devd.rss.anon_mb``). Nothing where
no report holds it."""


def read(run: dict):
    found = [((r["report"].get("devd") or {}).get("rss") or {}).get("anon_mb")
             for r in run["runs"]]
    found = [v for v in found if v is not None]
    return max(found) if found else None

"""GL007 fixture: per-item .tolist() inside a loop in a hot function."""


# graftlint: hot
def hot_convert(rows):
    out = []
    for row in rows:
        out.append(row.tolist())  # GL007: per-item conversion
    return out


# the batch idiom is clean: ONE conversion before the loop
# graftlint: hot
def hot_convert_batched(rows):
    host = rows.tolist()
    out = []
    for row in host:
        out.append(row)
    return out


# loops in cold functions are out of scope (fallback modules convert
# per item deliberately and are not hot-marked)
def cold_convert(rows):
    return [row.tolist() for row in rows]

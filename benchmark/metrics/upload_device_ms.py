"""upload_device_ms: the device milliseconds of one call's upload of its
two images, the work launched inside the program's ``depth.upload``
spans over their count."""


def read(ctx):
    upload = ((ctx.trace or {}).get("spans") or {}).get("depth.upload")
    if not upload or not upload["calls"]:
        return None
    return 1e3 * upload["device_s"] / upload["calls"]

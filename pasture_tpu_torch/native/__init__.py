"""Native (C++) runtime components.

Host-side native code fills the roles pasture delegates to Rust/C crates:
the LASzip codec (``laszip``, replacing the pure-Rust ``laz`` crate) and
record repack helpers.  Python fallbacks exist for every component so the
package works without the compiled extension; the extension accelerates.
"""
